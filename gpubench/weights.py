"""The model's weights, drawn on the device from the seed.

One ``randn`` over every parameter at once, then one multiply and one add
by per-parameter scales and offsets, in float32 (the port's master
weights).  Every tensor is drawn, none left at zero, so every path reaches
the logits: convolutions at He fan-in scale, the non-local and FBO
projections at 1 / fan-in (their attention then has logits of order one),
the non-local output at 0.2 of that, the classifier at 0.22 of that (its
logits then spread about 1 at the released sizes), the frozen affines
near 1 (each
residual branch's last near 0.2, so the 33 blocks do not blow the
activations up), biases 0.05 * N(0, 1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# role -> (mean, std or None for the fan-in rule, fan-in gain)
ROLES = {'conv': (0.0, None, 2.0), 'proj': (0.0, None, 1.0),
         'proj_out': (0.0, None, 0.04), 'classifier': (0.0, None, 0.05),
         'scale': (1.0, 0.1, None),
         'scale_out': (0.2, 0.02, None), 'bias': (0.0, 0.05, None)}


def draw(specs: List[Tuple[str, tuple, str]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for (name, shape, role) ``specs``: views of one
    float32 buffer."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    means, stds = [], []
    for _, shape, role in specs:
        mean, std, gain = ROLES[role]
        if std is None:
            std = math.sqrt(gain / math.prod(shape[1:]))
        means.append(mean)
        stds.append(std)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    counts = torch.tensor(sizes, device=device)
    flat.mul_(torch.repeat_interleave(torch.tensor(stds, device=device),
                                      counts))
    flat.add_(torch.repeat_interleave(torch.tensor(means, device=device),
                                      counts))
    return {name: part.view(shape) for (name, shape, _), part in
            zip(specs, torch.split(flat, sizes))}
