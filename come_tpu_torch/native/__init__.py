"""Native host code (C++ through ctypes): the multithreaded walk feeder.

Port of ``come_tpu/native``: for ``corpus="host"`` the walks are made on
host threads by ``walker.cpp`` and streamed to the card batch by batch
while it trains on the previous batch.  The library is built with g++ at
first use (``build.py``); a failed build raises.
"""

from come_tpu_torch.native.build import load_native
from come_tpu_torch.native.walker import HostWalkFeeder, host_random_walks

__all__ = ["load_native", "host_random_walks", "HostWalkFeeder"]
