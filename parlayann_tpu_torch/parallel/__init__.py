"""The multi-device modes on ``torch.distributed`` (counterpart of
parlayann_tpu/parallel): the per-shard replica mode (``sharded``), the
cluster-sharded capacity mode (``cluster_sharded``) and the global build
(``global_build``), over the meshes of ``mesh``."""
