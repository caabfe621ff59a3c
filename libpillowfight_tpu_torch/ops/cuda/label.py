"""Connected-component labels under pairwise links (kernel in
`csrc/label_links.cu`).

Replaces `libpillowfight_tpu/ops/pallas/flood_kernel.py`
`_label_sweep_kernel` (`label_components_pallas`) and serves
`morph.label_components_links`, which SWT's component pass calls.

Labels are int32 [B,H,W]: the least flat index y*W + x of the pixel's
component, H*W on invalid pixels. `links` is {(dy,dx): bool [B,H,W]} over
`OFFSETS`; links[d][b,y,x] joins (y,x) to (y+dy,x+dx). A link counts
only between two valid pixels of the page. The result is a unique fixed
point: the kernel finds it with a union-find (tile by tile in shared
memory, then across the tiles' borders), the plain version with the
reference's rounds of segmented-min scans and neighbour mins.
"""

from __future__ import annotations

import torch

from ... import _build
from ...core.bitmap import shift2d
from . import expect, use_kernel

OFFSETS = ((0, 1), (1, 0), (1, 1), (1, -1))  # the four undirected directions

launches = 0  # calls of the kernel wrapper (each three launches in a row)


def mask_links(valid: torch.Tensor, connectivity: int = 8) -> dict:
    """The links of plain 4- or 8-connectivity: every pair of valid
    neighbours."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    none = torch.zeros_like(valid)
    return {d: valid & shift2d(valid, d[0], d[1], False)
            if connectivity == 8 or 0 in d else none for d in OFFSETS}


def _link_planes(valid: torch.Tensor, links: dict) -> list:
    """The four link planes as bool, in `OFFSETS` order."""
    if set(links) != set(OFFSETS):
        raise ValueError(f"links must have the keys {OFFSETS}, got "
                         f"{sorted(links)}")
    for d in OFFSETS:
        if links[d].shape != valid.shape:
            raise ValueError(f"links[{d}] {tuple(links[d].shape)} vs valid "
                             f"{tuple(valid.shape)}")
    return [links[d].to(torch.bool) for d in OFFSETS]


def _seg_min(v: torch.Tensor, linked_next: torch.Tensor, dim: int,
             big: int) -> torch.Tensor:
    """Min of v over each maximal linked run along `dim`;
    linked_next[i] joins elements i and i + 1. Doubling: the span
    [i - d, i] is one run iff no gap lies between its ends."""
    n = v.shape[dim]
    gaps = torch.cumsum((~linked_next).to(torch.int32), dim=dim,
                        dtype=torch.int32)
    e = torch.zeros_like(gaps)  # gaps strictly before element i
    e.narrow(dim, 1, n - 1).copy_(gaps.narrow(dim, 0, n - 1))
    v = v.clone()
    d = 1
    while d < n:
        lo, hi = v.narrow(dim, 0, n - d), v.narrow(dim, d, n - d)
        same = e.narrow(dim, 0, n - d) == e.narrow(dim, d, n - d)
        hi.copy_(torch.minimum(hi, torch.where(same, lo, big)))
        lo.copy_(torch.minimum(lo, torch.where(same, hi, big)))
        d *= 2
    return v


def label_links_plain(valid: torch.Tensor, links: dict | None,
                      max_iters: int | None = None) -> torch.Tensor:
    """The reference's rounds in plain torch: segmented min along the
    rows' and the columns' links, then one neighbour min over all four
    directions, until a round changes nothing. links=None stands for the
    links of 8-connectivity."""
    valid = valid.to(torch.bool)
    b, h, w = valid.shape
    big = h * w
    if max_iters is None:
        max_iters = big + 2
    planes = _link_planes(valid, mask_links(valid) if links is None
                          else links)
    # a link counts only between two valid pixels of the page
    planes = [link & valid & shift2d(valid, dy, dx, False)
              for (dy, dx), link in zip(OFFSETS, planes)]
    idx = torch.arange(big, dtype=torch.int32,
                       device=valid.device).view(1, h, w)
    labels = torch.where(valid, idx, big).to(torch.int32)
    for _ in range(max_iters):
        new = _seg_min(labels, planes[0], 2, big)
        new = _seg_min(new, planes[1], 1, big)
        out = new
        for (dy, dx), link in zip(OFFSETS, planes):
            out = torch.minimum(out, torch.where(
                link, shift2d(new, dy, dx, big), big))
            out = torch.minimum(out, torch.where(
                shift2d(link, -dy, -dx, False),
                shift2d(new, -dy, -dx, big), big))
        new = torch.where(valid, out, big)
        if torch.equal(new, labels):
            break
        labels = new
    return labels


MAX_ROWS = 65535 * 32  # the kernel's grid: 65535 tiles of 32 rows


def label_links_cuda(valid: torch.Tensor, links: dict | None
                     ) -> torch.Tensor:
    """The kernel. links=None labels the 8-connected components of
    `valid` (the kernel derives those links itself). The kernel reads the
    four bool planes as they are and drops a link that leaves the page or
    meets an invalid pixel, so nothing is packed or masked here: a bool,
    contiguous plane reaches the launch without a pass over it."""
    valid = valid.to(torch.bool).contiguous()
    expect(valid, "valid", (torch.bool,), 3)
    b, h, w = valid.shape
    if h * w >= 2 ** 31 or b > 65535 or h > MAX_ROWS:
        raise ValueError(f"valid {tuple(valid.shape)}: a page must hold "
                         f"fewer than 2^31 pixels in at most {MAX_ROWS} "
                         f"rows, a batch at most 65535 pages")
    planes = [None] * 4
    if links is not None:
        planes = [p.contiguous() for p in _link_planes(valid, links)]
        for d, p in zip(OFFSETS, planes):
            expect(p, f"links[{d}]", (torch.bool,), 3)
    labels = torch.empty((b, h, w), dtype=torch.int32, device=valid.device)
    scratch = torch.empty(
        max(b * _build.host_size("pft_label_scratch_bytes", h, w), 1),
        dtype=torch.uint8, device=valid.device)
    _build.launch("pft_label_links", valid, valid.data_ptr(),
                  *(None if p is None else p.data_ptr() for p in planes),
                  labels.data_ptr(), scratch.data_ptr(), b, h, w)
    global launches
    launches += 1
    return labels


def label_links(valid: torch.Tensor, links: dict | None,
                max_iters: int | None = None) -> torch.Tensor:
    """int32 labels [B,H,W] of the components of `valid` under `links`
    (None: 8-connectivity). max_iters caps the plain version's rounds;
    the kernel always runs to the fixed point."""
    if use_kernel(valid, *(links or {}).values()):
        return label_links_cuda(valid, links)
    return label_links_plain(valid, links, max_iters)
