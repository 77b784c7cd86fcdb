"""Multi-process training: the mesh, ray-sharded data-parallel training and
multi-identity batched training (BASELINE config 5), over torch.distributed.
Port of dfanerf_tpu/parallel."""

from dfanerf_torch.parallel.mesh import make_mesh, make_sharded_train_step, replicate_state

__all__ = ["make_mesh", "make_sharded_train_step", "replicate_state"]
