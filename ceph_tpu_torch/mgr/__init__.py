"""mgr: the manager layer. Ported so far: the balancer module
(`BalancerModule`, upmap and crush-compat modes; the reference's
pybind/mgr/balancer/module.py), which optimizes placement on the batched
mapper and the move-scoring kernel and commits through the mon's command
path."""

from ceph_tpu_torch.mgr.balancer import BalancerModule

__all__ = ["BalancerModule"]
