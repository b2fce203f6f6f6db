"""Multi-device execution on `torch.distributed` (counterpart of
tfhe_tpu/parallel): the process mesh, the sharded PBS step, the sharded
NTT and key-sharded rotation, multi-host layouts, a launcher of local
worlds, and the batched-PBS dispatcher."""

from tfhe_tpu_torch.parallel.dispatch import PbsDispatcher
from tfhe_tpu_torch.parallel.mesh import make_mesh
from tfhe_tpu_torch.parallel.sharded import make_sharded_pbs_step

__all__ = ["PbsDispatcher", "make_mesh", "make_sharded_pbs_step"]
