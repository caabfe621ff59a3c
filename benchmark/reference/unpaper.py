"""The six unpaper filters of libpillowfight, applied one after another
to int32 RGBA words: each filter reads the gray plane of the page the
previous one left and sets its wiped pixels to white.

This is the straightforward order of the chain (the program threads two
bool planes between the filters instead). Parameters are given in full
by the configuration; their names are libpillowfight's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .planes import (BLACK_THRESHOLD, WHITE_THRESHOLD, block_sums, coverage,
                     flood, line_counts, scalar, small_clusters, words_gray,
                     words_s3, wipe_white)


def _dark(gray, black_threshold=BLACK_THRESHOLD):
    return gray < scalar(black_threshold * 255.0, gray)


def _nonwhite(gray):
    return gray < scalar(WHITE_THRESHOLD * 255.0, gray)


def blackfilter(words, gray, scan_size, scan_step, scan_threshold,
                black_threshold, intensity):
    """Scan squares whose dark ratio reaches the threshold seed a flood
    over the dark region, gaps up to `intensity` pixels leapt."""
    dark = _dark(gray, black_threshold)
    counts = block_sums(dark, scan_size, scan_step, gray.dtype)
    triggered = counts >= scalar(scan_threshold * scan_size * scan_size,
                                 counts)
    seeds = coverage(triggered, dark.shape, scan_size, scan_step) & dark
    return flood(seeds, dark, leap=intensity)


def noisefilter(words, gray, intensity):
    """8-connected clusters of at most `intensity` non-white pixels."""
    return small_clusters(_nonwhite(gray), intensity)


def blurfilter(words, gray, size, step, intensity):
    """Blocks whose non-white ratio is in (0, intensity] and whose eight
    neighbours at grid offset size // step are all at most intensity."""
    mask = _nonwhite(gray)
    ratios = block_sums(mask, size, step, gray.dtype) / float(size * size)
    d = max(size // step, 1)
    p = F.pad(ratios, (d, d, d, d))
    nby, nbx = ratios.shape[1], ratios.shape[2]
    neighbour_max = None
    for dy in (-d, 0, d):
        for dx in (-d, 0, d):
            if dy == 0 and dx == 0:
                continue
            n = p[:, d + dy: d + dy + nby, d + dx: d + dx + nbx]
            neighbour_max = n if neighbour_max is None else torch.maximum(
                neighbour_max, n)
    lim = scalar(intensity, ratios)
    lonely = (ratios > 0) & (ratios <= lim) & (neighbour_max <= lim)
    return coverage(lonely, mask.shape, size, step) & mask


def _mask_edge(counts, perp_extent, center, size, step, threshold,
               outward_is_down):
    n = counts.shape[1]
    cs = torch.cat([torch.zeros_like(counts[:, :1]),
                    torch.cumsum(counts, dim=1)], dim=1)
    if outward_is_down:
        k_max = max((center - size) // step + 1, 1)
        starts = center - size - torch.arange(k_max,
                                              device=counts.device) * step
    else:
        k_max = max((n - center - size) // step + 1, 1)
        starts = center + torch.arange(k_max, device=counts.device) * step
    in_range = (starts >= 0) & (starts + size <= n)
    safe = torch.clamp(starts, 0, max(n - size, 0))
    strip = cs[:, safe + size] - cs[:, safe]
    blank = (strip < scalar(threshold * size * perp_extent, strip)) & in_range
    first = torch.argmax(blank.to(torch.int32), dim=1)
    if outward_is_down:
        return torch.where(blank.any(dim=1), starts[first], 0)
    return torch.where(blank.any(dim=1), starts[first] + size, n)


def masks(words, gray, scan_size, scan_step, scan_threshold):
    """From the page centre a strip slides outward in each direction; the
    mask edge is the first strip whose dark ratio falls below the
    threshold. Everything outside the mask rectangle is wiped."""
    rows, cols = line_counts(_dark(gray), gray.dtype)
    h, w = rows.shape[1], cols.shape[1]
    sy, sx = h // 2, w // 2
    args = (scan_size, scan_step, scan_threshold)
    left = _mask_edge(cols, h, sx, *args, True)[:, None, None]
    right = _mask_edge(cols, h, sx, *args, False)[:, None, None]
    top = _mask_edge(rows, w, sy, *args, True)[:, None, None]
    bottom = _mask_edge(rows, w, sy, *args, False)[:, None, None]
    ys = torch.arange(h, device=gray.device).view(1, h, 1)
    xs = torch.arange(w, device=gray.device).view(1, 1, w)
    return ~(((xs >= left) & (xs < right)) & ((ys >= top) & (ys < bottom)))


def grayfilter(words, gray, size, step, threshold):
    """Blocks with no dark pixel whose mean gray exceeds
    255 * (1 - threshold), tested on exact sums of r + g + b."""
    dark_counts = block_sums(_dark(gray), size, step, torch.float32)
    s3_sums = block_sums(words_s3(words), size, step, torch.float32)
    bound = scalar(765.0 * (1.0 - threshold) * float(size * size), s3_sums)
    wipe = (dark_counts == 0) & (s3_sums > bound)
    return coverage(wipe, gray.shape, size, step)


def _border_extent(counts, extent, size, step, threshold, from_end):
    if from_end:
        counts = torch.flip(counts, dims=(1,))
    cs = torch.cat([torch.zeros_like(counts[:, :1]),
                    torch.cumsum(counts, dim=1)], dim=1)
    k_max = max((extent // 2 - size) // step + 1, 1)
    starts = torch.arange(k_max, device=counts.device) * step
    strip = cs[:, starts + size] - cs[:, starts]
    has_content = strip > scalar(threshold, strip)
    first = torch.argmax(has_content.to(torch.int32), dim=1)
    first = torch.where(has_content.any(dim=1), first, k_max)
    return (first * step).to(torch.int32)


def border(words, gray, scan_size, scan_step, scan_threshold):
    """From each edge, strips of `scan_size` at `scan_step` up to half the
    page; the border ends at the first strip with more dark pixels than
    the threshold, and the border is wiped."""
    rows, cols = line_counts(_dark(gray), gray.dtype)
    h, w = rows.shape[1], cols.shape[1]
    args = (scan_size, scan_step, scan_threshold)
    top = _border_extent(rows, h, *args, False)[:, None, None]
    bottom = _border_extent(rows, h, *args, True)[:, None, None]
    left = _border_extent(cols, w, *args, False)[:, None, None]
    right = _border_extent(cols, w, *args, True)[:, None, None]
    ys = torch.arange(h, device=gray.device).view(1, h, 1)
    xs = torch.arange(w, device=gray.device).view(1, 1, w)
    return ((ys < top) | (ys >= h - bottom)) | ((xs < left) | (xs >= w - right))


FILTERS = {
    "unpaper_blackfilter": blackfilter,
    "unpaper_noisefilter": noisefilter,
    "unpaper_blurfilter": blurfilter,
    "unpaper_masks": masks,
    "unpaper_grayfilter": grayfilter,
    "unpaper_border": border,
}


def apply(words: torch.Tensor, name: str, params: dict,
          ft=torch.float32) -> torch.Tensor:
    """One unpaper filter on int32 words [B,H,W]; the same words with its
    wiped pixels white."""
    wipe = FILTERS[name](words, words_gray(words, ft), **params)
    return wipe_white(words, wipe)
