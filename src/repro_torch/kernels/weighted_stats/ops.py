"""Bootstrap moments: of an explicit weight matrix, and matrix-free; and
the tile scan every fused path shares.

``weighted_moments`` contracts an explicit (B, n) weight matrix W with X
and X² (the materialized engines).  A CUDA tensor launches the
hand-written kernel (csrc/weighted_moments.cu, replacing the TPU kernel
repro/kernels/weighted_stats/kernel.py: weighted_moments_kernel) or
raises; a CPU tensor runs the plain version, ``ref.weighted_moments_ref``.

``fused_poisson_moments`` gives, for B resamples under implicit Poisson(1)
weights W (never stored), w_tot = ΣW (B,), s1 = W·X and s2 = W·X² (B, d);
with ``group_ids`` (GROUP BY) one such slot per key, (B, G) and (B, G, d).
Dispatch is on the device of ``values``: a CUDA tensor launches the
hand-written kernel (csrc/fused_pass.cu without histograms, replacing
the TPU kernel repro/kernels/weighted_stats/kernel.py:
fused_poisson_moments_kernel; keyed, csrc/fused_grouped.cu, replacing
fused_poisson_moments_grouped_kernel; with ``stream=True``,
csrc/fused_stream.cu, replacing fused_poisson_moments_stream_kernel) or
raises; a CPU tensor runs the plain version, the JAX package's scan
lowering tile by tile in the same tile order.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._pass import (MAX_ROWS, check_cuda_f32,
                                       explicit_geometry, grouped_geometry,
                                       pass_geometry, stream_ptr)
from repro_torch.kernels.poisson_counts.ops import poisson_counts
from repro_torch.kernels.poisson_counts.ref import (tiles_per_chunk,
                                                    weight_block,
                                                    weight_tile_blocks)
from repro_torch.kernels.weighted_stats.ref import weighted_moments_ref


def _pad_to(x: torch.Tensor, mult: int, axis: int,
            value: float = 0.0) -> torch.Tensor:
    """Pad ``axis`` with ``value`` up to a multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                     device=x.device)], dim=axis)


def weighted_moments(weights: torch.Tensor, values: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """weights (B, n) × values (n, d) or (n,) -> (w_tot (B,), s1 (B, d),
    s2 (B, d)).

    On the card, kernel 11: w_tot is the exact total of whole-number
    weights rounded once (bitwise the plain version's), s1 and s2 are
    summed in a fixed order and agree with the plain version within
    1e-5·Σw|x| and 1e-5·Σw·x²; repeated runs are bitwise equal."""
    if not isinstance(values, torch.Tensor):
        raise TypeError("weighted_moments takes torch.Tensors; the device "
                        "of the values picks the kernel or the plain "
                        "version")
    x = values if values.ndim == 2 else values.reshape(values.shape[0], -1)
    w = weights.to(torch.float32)
    if w.ndim != 2 or w.shape[1] != x.shape[0]:
        raise ValueError(f"weights {tuple(w.shape)} do not match values "
                         f"{tuple(x.shape)}: expected (B, n)")
    if x.device.type == "cuda":
        return weighted_moments_cuda(w.contiguous(),
                                     x.to(torch.float32).contiguous())
    return weighted_moments_ref(w, x)


weighted_moments.launches = 0


def weighted_moments_cuda(w: torch.Tensor, x: torch.Tensor):
    """Kernel 11 (csrc/weighted_moments.cu) on the card."""
    check_cuda_f32("weights", w)
    check_cuda_f32("values", x)
    (B, n), d = w.shape, x.shape[1]

    def e(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)
    if B == 0 or n == 0:
        return tuple(t.zero_() for t in (e(B), e(B, d), e(B, d)))
    rows = min(MAX_ROWS, B)
    cols, ranges = explicit_geometry(B, n, rows)
    parts = (e(B, ranges), e(B, ranges, d), e(B, ranges, d))
    out = (e(B), e(B, d), e(B, d))
    weighted_moments.launches += 1
    _build.launch("weighted_moments", B, n, d, w.data_ptr(), x.data_ptr(),
                  rows, cols, ranges, *[t.data_ptr() for t in parts + out],
                  stream_ptr(x.device))
    return out


def implicit_weight_tile(seed: int, n_valid: int, t: int, B: int,
                         block_b: int, block_n: int,
                         valid: Optional[torch.Tensor] = None,
                         device="cpu") -> torch.Tensor:
    """The (B, block_n) weight tile at n-tile ``t`` (B a block_b multiple)."""
    return weight_block(int(seed), int(n_valid), B, block_b, block_n, t,
                        t + 1, valid=valid, device=device)


def implicit_weights(seed: int, B: int, n: int, device=None) -> torch.Tensor:
    """The (B, n) weight matrix the fused paths use implicitly."""
    return poisson_counts(seed, B, n, device=device)


class Prepared:
    """A fused call's arguments, padded to whole RNG tiles.  A keyed call
    also carries its (np_,) f32 key column ``gp`` (padding: key 0, whose
    weights n_valid already zeroes) and ``G``."""

    def __init__(self, values: torch.Tensor, B: int, n_valid, valid_mask,
                 group_ids=None, num_groups=None):
        x = values if values.ndim == 2 else values.reshape(values.shape[0],
                                                           -1)
        self.n, self.d = x.shape
        self.bb, self.bn = weight_tile_blocks(B, self.n)
        self.B = B
        self.Bp = B + (-B) % self.bb
        self.n_valid = self.n if n_valid is None else int(n_valid)
        self.xp = _pad_to(x.to(torch.float32), self.bn, 0).contiguous()
        self.np_ = self.xp.shape[0]
        self.mp = None
        if valid_mask is not None:
            m = torch.as_tensor(valid_mask).to(device=x.device,
                                               dtype=torch.float32)
            self.mp = _pad_to(m.reshape(self.n), self.bn, 0).contiguous()
        self.gp, self.G = None, None
        if group_ids is not None:
            if num_groups is None or int(num_groups) < 1:
                raise ValueError("group_ids requires num_groups >= 1, got "
                                 f"{num_groups!r}")
            g = torch.as_tensor(group_ids).to(device=x.device,
                                              dtype=torch.float32)
            self.gp = _pad_to(g.reshape(self.n), self.bn, 0).contiguous()
            self.G = int(num_groups)
        self.device = x.device


def prepare(values: torch.Tensor, B: int, n_valid=None, valid_mask=None,
            group_ids=None, num_groups=None) -> Prepared:
    if not isinstance(values, torch.Tensor):
        raise TypeError("fused ops take a torch.Tensor; its device picks "
                        "the kernel (cuda) or the plain version (cpu)")
    if values.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {values.device}")
    return Prepared(values, int(B), n_valid, valid_mask, group_ids,
                    num_groups)


def key_masks(pr: Prepared, g_tile: torch.Tensor) -> torch.Tensor:
    """(G, bn) exact 0/1 masks (key == g) of a key tile."""
    keys = torch.arange(pr.G, dtype=torch.float32, device=g_tile.device)
    return (g_tile[None, :] == keys[:, None]).to(torch.float32)


def tile_scan(pr: Prepared, seed: int, consume: Callable[..., None]) -> None:
    """The scan lowering: every (Bp, bn) weight tile in n order,
    handed to ``consume(w_tile, x_tile)`` with its (bn, d) x tile, and,
    for a keyed call, its (bn,) key tile as a third argument.
    Weights are drawn a chunk of tiles at a time."""
    nt = pr.np_ // pr.bn
    step = tiles_per_chunk(pr.Bp, pr.bn)
    for c0 in range(0, nt, step):
        c1 = min(nt, c0 + step)
        valid = None if pr.mp is None else pr.mp[c0 * pr.bn:c1 * pr.bn]
        w = weight_block(int(seed), pr.n_valid, pr.Bp, pr.bb, pr.bn, c0, c1,
                         valid=valid, device=pr.device)
        for t in range(c0, c1):
            lo = (t - c0) * pr.bn
            cols = slice(t * pr.bn, (t + 1) * pr.bn)
            if pr.gp is None:
                consume(w[:, lo:lo + pr.bn], pr.xp[cols])
            else:
                consume(w[:, lo:lo + pr.bn], pr.xp[cols], pr.gp[cols])


def moments_plain(pr: Prepared, seed: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: (w_tot (Bp,), s1 (Bp, d), s2 (Bp, d)).

    Each tile's sums are f32, as in the JAX package's scan; the running
    sums across tiles are float64, rounded to f32 once at the end.  So
    w_tot is the exact total of the integer weights, bitwise the kernel's
    at any n, and s1/s2 carry no error that grows with the tile count.
    (The JAX package's f32 running sums give the same w_tot while it stays
    below 2^24, and round at every tile past that.)"""
    acc = [torch.zeros(pr.Bp, dtype=torch.float64, device=pr.device),
           torch.zeros(pr.Bp, pr.d, dtype=torch.float64, device=pr.device),
           torch.zeros(pr.Bp, pr.d, dtype=torch.float64, device=pr.device)]

    def consume(w, xt):
        acc[0] = acc[0] + w.sum(dim=1)
        acc[1] = acc[1] + w @ xt
        acc[2] = acc[2] + w @ (xt * xt)

    tile_scan(pr, seed, consume)
    return tuple(a.float() for a in acc)


def grouped_moments_plain(pr: Prepared, seed: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain keyed version: (w_tot (Bp, G), s1 (Bp, G, d), s2 (Bp, G, d)),
    the JAX package's ``_grouped_fused_scan``.  Slot g runs
    ``moments_plain``'s tile math on w · (key == g), with float64 running
    sums, so it is bitwise ``moments_plain`` under
    ``valid_mask = valid · (key == g)``: 0/1 masks compose exactly."""
    f64 = dict(dtype=torch.float64, device=pr.device)
    acc = [torch.zeros(pr.Bp, pr.G, **f64),
           torch.zeros(pr.Bp, pr.G, pr.d, **f64),
           torch.zeros(pr.Bp, pr.G, pr.d, **f64)]

    def consume(w, xt, gt):
        x2 = xt * xt
        for g, m in enumerate(key_masks(pr, gt)):
            wg = w * m[None, :]
            acc[0][:, g] += wg.sum(dim=1)
            acc[1][:, g] += wg @ xt
            acc[2][:, g] += wg @ x2

    tile_scan(pr, seed, consume)
    return tuple(a.float() for a in acc)


def moment_buffers(pr: Prepared, ranges: int):
    """Partials and outputs of a moments pass, allocated on the card."""
    def e(*shape):
        return torch.empty(shape, dtype=torch.float32, device=pr.device)
    return (e(pr.Bp, ranges), e(pr.Bp, ranges, pr.d),
            e(pr.Bp, ranges, pr.d), e(pr.Bp), e(pr.Bp, pr.d),
            e(pr.Bp, pr.d))


def mask_ptr(pr: Prepared) -> Optional[int]:
    if pr.mp is None:
        return None
    check_cuda_f32("valid_mask", pr.mp)
    return pr.mp.data_ptr()


def moments_cuda(pr: Prepared, seed: int):
    check_cuda_f32("values", pr.xp)
    tpc, ranges = pass_geometry(pr.Bp, pr.np_, pr.bn)
    bufs = moment_buffers(pr, ranges)
    fused_poisson_moments.launches += 1
    _build.launch("fused_pass", int(seed), pr.n_valid, pr.Bp, pr.np_,
                  pr.bb, pr.bn, pr.d, pr.xp.data_ptr(), mask_ptr(pr),
                  MAX_ROWS, tpc, ranges, *[b.data_ptr() for b in bufs],
                  0, None, None, None, 0, None, stream_ptr(pr.device))
    return bufs[3], bufs[4], bufs[5]


def moments_stream_cuda(pr: Prepared, seed: int):
    """Kernel 5 (csrc/fused_stream.cu) over a prepared call: kernel 2's
    outputs, bitwise, with x and the mask double-buffered through shared
    memory by cp.async."""
    check_cuda_f32("values", pr.xp)
    tpc, ranges = pass_geometry(pr.Bp, pr.np_, pr.bn)
    bufs = moment_buffers(pr, ranges)
    moments_stream_cuda.launches += 1
    _build.launch("fused_stream", int(seed), pr.n_valid, pr.Bp, pr.np_,
                  pr.bb, pr.bn, pr.d, pr.xp.data_ptr(), mask_ptr(pr),
                  MAX_ROWS, tpc, ranges, *[b.data_ptr() for b in bufs],
                  stream_ptr(pr.device))
    return bufs[3], bufs[4], bufs[5]


moments_stream_cuda.launches = 0


def grouped_moments_cuda(pr: Prepared, seed: int):
    """Kernel 6 (csrc/fused_grouped.cu) over a prepared keyed call:
    (w_tot (Bp, G), s1 (Bp, G, d), s2 (Bp, G, d)) on the card."""
    check_cuda_f32("values", pr.xp)
    check_cuda_f32("group_ids", pr.gp)
    tpc, ranges = pass_geometry(pr.Bp, pr.np_, pr.bn)
    dc, kg, rows, _ = grouped_geometry(pr.G, pr.d)

    def e(*shape):
        return torch.empty(shape, dtype=torch.float32, device=pr.device)
    parts = (e(pr.Bp, ranges, pr.G), e(pr.Bp, ranges, pr.G, pr.d),
             e(pr.Bp, ranges, pr.G, pr.d))
    out = (e(pr.Bp, pr.G), e(pr.Bp, pr.G, pr.d), e(pr.Bp, pr.G, pr.d))
    grouped_moments_cuda.launches += 1
    _build.launch("fused_grouped", int(seed), pr.n_valid, pr.Bp, pr.np_,
                  pr.bb, pr.bn, pr.d, pr.G, pr.xp.data_ptr(), mask_ptr(pr),
                  pr.gp.data_ptr(), dc, kg, rows, tpc, ranges,
                  *[t.data_ptr() for t in parts + out], 0, None, None, None,
                  stream_ptr(pr.device))
    return out


grouped_moments_cuda.launches = 0


def fused_poisson_moments(seed: int, values: torch.Tensor, B: int,
                          n_valid=None, valid_mask=None,
                          stream: bool = False, group_ids=None,
                          num_groups=None):
    """values (n, d) or (n,) -> (w_tot (B,), s1 (B, d), s2 (B, d)).

    ``n_valid`` zeroes weight columns >= n_valid; ``valid_mask`` ((n,)
    exact 0/1) multiplies the weights after that, so a prefix-shaped mask
    reproduces ``n_valid`` bit for bit.

    ``group_ids`` ((n,) keys 0..num_groups-1, float storage is fine)
    segment-reduces the same weights per key: (w_tot (B, G), s1 (B, G, d),
    s2 (B, G, d)), slot g bitwise the call under
    ``valid_mask = valid · (group_ids == g)``.

    ``stream=True`` runs the double-buffered kernel 5 on the card (x and
    the mask copied into shared memory a tile ahead of the hash), with
    outputs bitwise those of the default kernel 2; the plain version is
    the same for both."""
    pr = prepare(values, B, n_valid, valid_mask, group_ids, num_groups)
    if stream and pr.gp is not None:
        raise ValueError("stream=True is not supported with group_ids "
                         "(the grouped kernel keeps its G·d accumulators "
                         "resident instead)")
    cuda = pr.device.type == "cuda"
    if pr.gp is not None:
        out = grouped_moments_cuda(pr, seed) if cuda else \
            grouped_moments_plain(pr, seed)
    elif cuda:
        out = moments_stream_cuda(pr, seed) if stream else \
            moments_cuda(pr, seed)
    else:
        out = moments_plain(pr, seed)
    return tuple(t[:pr.B] for t in out)


fused_poisson_moments.launches = 0
