"""Several cards: the device mesh and its grammar, the cluster, the data-
and tensor-parallel collectives and the launch of one rank a card.
Counterpart of ``deal_yolo_daya_tpu/parallel``."""

from .mesh import (Mesh, create_hybrid_mesh, create_mesh, device_summary,  # noqa: F401
                   init_distributed, mesh_from_spec, visible_devices)
from .sharding import DataParallel, ModelParallel, tp_param_shardings  # noqa: F401
