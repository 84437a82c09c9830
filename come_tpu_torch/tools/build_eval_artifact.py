"""Assemble EVAL_gpu_rNN.json from eval_sweep result files.

Port of ``scripts/build_eval_artifact.py`` (``main``, ``:25-62``):

    python -m come_tpu_torch.tools.build_eval_artifact \\
        --out EVAL_gpu_r01.json --inputs rows1.json rows2.json ...

The artifact is the port's committed quality record: NMI, macro/micro-F1
and the deepwalk train-ratio sweep for every registered dataset and the
mesh rows, as ``tools/eval_sweep.py`` measured them on the card named in
``platform``.  It has the JAX artifact's top-level keys (``artifact``,
``protocol``, ``platform``, ``git``, ``results``); ``platform`` is
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of the
card this runs on (``--platform`` names it instead), never a JAX backend
string; ``git`` is ``git rev-parse --short HEAD`` (``--git`` names it
where the checkout has no history).  ``tests/test_torch_eval.py`` pins
its structure and floors.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

# the JAX artifact's protocol, word for word: the port's sweep runs the
# same one
PROTOCOL = (
    "scripts/eval_sweep.py full presets (+ --fast for mesh "
    "runs); NMI = argmax(pi) vs ground truth; F1 = OvR "
    "logistic, deepwalk top-k multi-label protocol; "
    "f1_by_train_ratio at {0.1,0.3,0.5,0.7,0.9}"
)


def build(out: str, inputs: list[str], platform: str | None = None,
          rev: str | None = None) -> dict:
    """The artifact of the rows in ``inputs`` (JSON lists), in order."""
    from come_tpu_torch.tools.eval_sweep import card_name

    results = []
    for f in inputs:
        results.extend(json.loads(Path(f).read_text()))
    if rev is None:
        rev = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=Path(__file__).resolve().parents[2],
        ).stdout.strip()
    return {
        "artifact": Path(out).name,
        "protocol": PROTOCOL,
        "platform": platform if platform is not None else card_name(),
        "git": rev,
        "results": results,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--platform", default=None)
    p.add_argument("--git", default=None)
    args = p.parse_args(argv)
    art = build(args.out, args.inputs, args.platform, args.git)
    Path(args.out).write_text(json.dumps(art, indent=2) + "\n")
    print(f"wrote {args.out} with {len(art['results'])} rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
