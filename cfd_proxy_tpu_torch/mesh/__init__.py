"""L1/L2: mesh I/O, data model, generation, partitioning, comm metadata.

Reference equivalents: `reader.c` (netCDF partitioned-mesh reader),
`comm_data.h` / `setup_comm.c` (per-neighbor send/recv index lists) — see
SURVEY.md §2 L1/L2 and §4.4.  The reference reads partitions produced by an
*offline* partitioner; this package additionally ships that offline tool
(`generator.py` + `partition.py`) because the sandbox has no network access to
the DLR F6 dataset (SURVEY.md §7 hard part 5).

The port's copy of `cfd_proxy_tpu/mesh/__init__.py`: the port imports nothing of the
JAX package, so it carries its own host layer; tests/test_torch_host.py holds the
two equal (code and outputs).
"""

from cfd_proxy_tpu_torch.mesh.model import CommEntry, MeshPartition
from cfd_proxy_tpu_torch.mesh.generator import generate_mesh
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.mesh.reader import read_partition, write_partition

__all__ = [
    "CommEntry",
    "MeshPartition",
    "generate_mesh",
    "partition_mesh",
    "read_partition",
    "write_partition",
]
