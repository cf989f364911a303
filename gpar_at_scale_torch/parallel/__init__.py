from gpar_at_scale_torch.parallel.mesh import make_mesh, replicated, shard_along
from gpar_at_scale_torch.parallel.sharded import make_dtc_nlml, make_sharded_train_step
from gpar_at_scale_torch.parallel.distributed import global_mesh, initialize_distributed
