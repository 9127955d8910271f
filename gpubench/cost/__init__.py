"""The benchmark's yardsticks, computed from shapes: the model's FLOPs on
the frozen reference (:mod:`gpubench.cost.flops`) and each hand kernel's
operations and bytes (:mod:`gpubench.cost.kernels`)."""
