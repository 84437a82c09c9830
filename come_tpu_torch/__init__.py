"""come_tpu_torch — the PyTorch/CUDA port of come_tpu (ComE graph embedding).

A second package beside ``come_tpu/``, which stays the JAX reference.  It
imports torch and numpy, never jax or come_tpu.  Modules keep the paths and
public names of their ``come_tpu`` counterparts:

* ``config/``     — ``ComEConfig`` and ``PRESETS`` (identical values)
* ``graphs/``     — numpy CSR container, SBM generator, file loaders,
  the dataset registry (karate, ``.mat`` files or their SBM stand-ins)
* ``sampling/``   — alias negatives, device random walks, star layout,
  skip-gram window pairs and subsampling
* ``models/``     — ``ComEParams`` as an ``nn.Module`` of buffers
* ``ops/``        — the hand-written CUDA kernels (``csrc/``), their plain
  PyTorch versions, the nvcc/ctypes build, and the sparse row primitives
* ``losses/``     — per-pair and shared-pool SGNS math, GMM EM and the O3
  community step (torch ops)
* ``evaluation/`` — NMI in numpy, node-classification F1 (logistic
  regression by L-BFGS in torch, no sklearn), plots (matplotlib imported
  only when one is drawn), the numpy gradient oracle and the gradient
  parity harness (a CLI)
* ``iohelpers/``  — word2vec-text embeddings and ``.npz`` checkpoints that
  the JAX package can load, and that load JAX checkpoints
* ``native/``     — the C++ host walker (g++ at first use, ctypes) and
  its feeder thread, for ``corpus="host"``
* ``metrics/``    — throughput meter, JSONL scalar log, profiler traces
* ``trainer/``    — the alternating ComE loop on one device
* ``parallel/``   — data-parallel training over ``torch.distributed``: the
  mesh of processes, the delta all-reduce rule, ``ShardedComETrainer``
* ``tools/``      — measurement scripts run on the card (the probes P2-P4,
  the O1 table-dtype A/B, the data-parallel check)
* ``main.py``     — the CLI

The GMM and O3 products must stay in full float32, so TF32 is switched off
for matmuls and cuDNN when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
