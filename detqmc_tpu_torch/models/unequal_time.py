"""Helpers shared by the models' unequal-time (dynamics) measurements.

The stabilized solves give G(tau, 0), G(0, tau) and G(tau, tau) on the
stabilization grid tau = k s (the anchors, k = 0..K). Every slice in
between comes from B-wraps off the anchor below it, as the reference's
TimeDisplaced path does it (SURVEY.md §3 "DQMC core", §9 "Unequal-time");
the wrap that reaches the next anchor is compared with it, like the
sweep's green_dev. The JAX package runs the K intervals in a
``lax.scan``; here all K intervals of all walkers wrap at once, one
batched apply per slice offset j = 0..s-1.
"""

from __future__ import annotations

import torch


def wrap_between_anchors(anchors, s: int, step):
    """Fill every slice between the anchors.

    ``anchors``: chains, each (W, K+1, ...) with the anchor axis second;
    ``step(j, chains)`` returns the chains (each (W, K, ...): interval k's
    value at slice k s + j) carried one slice on, to k s + j + 1.
    Returns (the per-slice chains, each (W, K s + 1, ...), and the wrap
    deviation (W,): max |wrapped - stabilized| at the anchors 1..K over
    every chain)."""
    W, K = anchors[0].shape[0], anchors[0].shape[1] - 1
    outs, views = [], []
    for a in anchors:
        out = a.new_empty((W, K * s + 1) + a.shape[2:])
        out[:, -1] = a[:, K]
        outs.append(out)
        views.append(out[:, :K * s].view((W, K, s) + a.shape[2:]))
    cur = [a[:, :K] for a in anchors]
    for j in range(s):
        for v, c in zip(views, cur):
            v[:, :, j] = c
        cur = step(j, cur)
    dev = torch.stack([(c - a[:, 1:]).abs().flatten(1).amax(1)
                       for c, a in zip(cur, anchors)]).amax(0)
    return outs, dev


def trapezoid_weights(m: int, dtau: float, dtype, device) -> torch.Tensor:
    """(m+1,) trapezoid weights of the tau integral over every slice."""
    w = torch.full((m + 1,), dtau, dtype=dtype, device=device)
    w[0] *= 0.5
    w[-1] *= 0.5
    return w
