"""The benchmark's yardsticks, computed from shapes: the model's FLOPs on
the frozen reference (:mod:`gpubench.cost.flops`), each hand kernel's
operations and bytes (:mod:`gpubench.cost.kernels`), and each reference
network's launches of those kernels (``cost/<reference>.py``, such as
:mod:`gpubench.cost.model`)."""
