"""Benes-network routing for static permutations.

`lax.sort` with constant keys executes a bitonic network — O(log^2 N) passes.
A Benes network routes ANY fixed permutation in 2*log2(N)-1 passes; for the
delta-exchange permutations (uniform.ExchangePlan) that is ~10x fewer passes
over the array. Each stage s has a fixed butterfly distance m and applies

    y[v] = x[v ^ m] if swap[s][v] else x[v]

which is a block-swap (reshape/flip) + select — dense vector work, no
gather/scatter/sort. The network routes out[i] = in[perm[i]].

Construction (host, numpy, fully vectorized, no Python recursion): classic
Waksman looping, processing ALL sub-networks of a level at once. The
input-mate/output-mate constraints form disjoint even cycles; the half
assignment is the 2-coloring computed via pointer-doubling orbit minima of
the color-preserving skip permutation sigma = in_mate . out_mate.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _orbit_min(nxt: np.ndarray, max_cycle: int) -> np.ndarray:
    """Minimum element over each orbit of permutation ``nxt`` (pointer
    doubling); orbits are guaranteed shorter than ``max_cycle``."""
    best = np.arange(nxt.size, dtype=np.int32)
    jump = nxt
    steps = 1
    while steps < max_cycle:
        best = np.minimum(best, best[jump])
        jump = jump[jump]
        steps *= 2
    return best


def route_benes(perm: np.ndarray) -> List[Tuple[int, np.ndarray]]:
    """Switch settings routing out[i] = in[perm[i]] on a Benes network.

    ``perm``: permutation of [0, N), N a power of two. Returns stages
    [(m, swap_mask[N] bool)] applied in order: y[v] = x[v ^ m] where mask.
    2*log2(N) - 1 stages; masks are symmetric (mask[v] == mask[v ^ m]).
    """
    perm = np.asarray(perm, dtype=np.int32)
    N = perm.size
    assert N and N & (N - 1) == 0, "N must be a power of two"
    assert N < 2**31
    if N == 1:
        return []
    idx = np.arange(N, dtype=np.int32)
    front: List[Tuple[int, np.ndarray]] = []
    back: List[Tuple[int, np.ndarray]] = []
    cur = perm.copy()  # block-local sub-permutations, concatenated
    n = N
    while n > 2:
        m = n // 2
        base = idx & ~(n - 1)
        loc = idx & (n - 1)
        in_mate = idx ^ m
        src = base + cur  # global source index per out slot
        out_mate = np.empty(N, dtype=np.int32)
        out_mate[src] = src[idx ^ m]
        sigma = in_mate[out_mate]
        omin = _orbit_min(sigma, n)  # sigma orbits live inside one block
        cyc = np.minimum(omin, omin[in_mate])
        h = (omin != cyc).astype(np.int32)  # 0 = top sub-network
        swap_in = h == (loc < m)
        front.append((m, swap_in))
        pos_after = base + (loc & (m - 1)) + h * m  # slot after input stage
        g = h[src]  # half carrying the element destined for each out slot
        swap_out = g == (loc < m)
        back.append((m, swap_out))
        # next-level block-local permutations (blocks of size m)
        j_global = base + (loc & (m - 1)) + g * m  # sub-output physical slot
        new_cur = np.empty(N, dtype=np.int32)
        new_cur[j_global] = pos_after[src] & (m - 1)
        cur = new_cur
        n = m
    # base level: blocks of 2, cur in {0,1} block-local
    pair_base = idx & ~1
    swap = cur[pair_base] == 1
    stages = front + [(1, swap)] + back[::-1]
    return stages


def apply_network_np(stages, x: np.ndarray) -> np.ndarray:
    """Reference applier (numpy)."""
    y = np.asarray(x).copy()
    idx = np.arange(y.shape[0])
    for m, mask in stages:
        y = np.where(mask, y[idx ^ m], y)
    return y


def apply_network_jax(dists, masks, xs):
    """Apply the network to one or more same-length arrays (shared masks).

    ``dists``: static tuple of butterfly distances; ``masks``: matching tuple
    of bool [N] device arrays; ``xs``: tuple of [N] arrays. The per-stage op
    lowers to a block-flip (reshape + reverse) and a select — no
    gather/scatter/sort.
    """
    import jax.numpy as jnp

    xs = list(xs)
    for m, mask in zip(dists, masks):
        for i, x in enumerate(xs):
            sw = x.reshape(-1, 2, m)[:, ::-1, :].reshape(x.shape)
            xs[i] = jnp.where(mask, sw, x)
    return tuple(xs)
