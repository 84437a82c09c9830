"""Sharded training over ``torch.distributed``: data-parallel rows and
row-sharded tables (``mesh.py``, ``distributed.py``, ``collectives.py``,
``exchange.py``, ``walk_exchange.py``, ``sharded.py``)."""

from come_tpu_torch.parallel.distributed import initialize_distributed
from come_tpu_torch.parallel.mesh import Mesh, MeshLayout, make_mesh
from come_tpu_torch.parallel.sharded import ShardedComETrainer

__all__ = [
    "Mesh",
    "MeshLayout",
    "ShardedComETrainer",
    "initialize_distributed",
    "make_mesh",
]
