"""SWT taken apart stage by stage on the card: gradients and edges, the
width maps, the ray medians, the labelling, the letter statistics (the
counterpart of the reference's `tools/profile_swt.py`).

    python -m libpillowfight_tpu_torch.tools.profile_swt

On one A4 page of `utils.pages.text_pages` (about 1,600 glyphs) as
int32 words: `swt_stages` runs SWT through the port's own stage
functions, as `swt` strings them together, with CUDA events around each
stage, after one warm call of `swt`; then the whole of `swt` (mode 0)
by `metrics.device_time`. The width maps are timed twice: as the plain
passes' three stages, and as `swt` computes them (`KERNEL_STAGE`, the
edge classes included: the kernels of `ops/cuda/swt_maps.py` on a card,
the plain passes again on the CPU), which "sum of stages" leaves out.
`chip_smoke.py` takes its stages from here too. The record goes to
`chiprun_out/profile_swt_torch.json`. Raises without a card;
`measure(device="cpu")` computes every stage on the CPU and writes "not
measured" for every time.
"""

from __future__ import annotations

import contextlib

import torch

from ..core.bitmap import pages_to_words, words_to_gray
from ..ops import swt as S
from ..ops.canny import canny_gradients, canny_strong_weak
from ..ops.morph import flood_reach, label_components_links
from ..utils.pages import text_pages
from . import timing

KERNEL_STAGE = "width maps, as swt takes them (kernels on a card)"


class Stages:
    """Device time by stage name, from CUDA events around each stage
    (summed over the stage's entries); NOT_MEASURED off the card."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on_card:
            yield
            self.ms[name] = timing.NOT_MEASURED
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        torch.cuda.synchronize()
        self.ms[name] = self.ms.get(name, 0.0) + start.elapsed_time(end)


def swt_stages(words: torch.Tensor, max_len: int = 128,
               keep_links: bool = False) -> dict:
    """SWT taken stage by stage through the port's own stage functions,
    as `swt` strings them together: the planes it builds on the way (the
    letter mask, the boxes; with `keep_links` the label kernel's inputs)
    and each stage's device time."""
    st = Stages(words.is_cuda)
    b, h, w = words.shape
    with st("gray"):
        gray = words_to_gray(words)
    with st("gradients and edges"):
        gx, gy = canny_gradients(gray)
        strong, weak = canny_strong_weak(gx, gy)
        edges = flood_reach(strong, weak)
    step = max(1, S._MAPS_CHUNK_PIXELS // (h * w))
    minus, plus = [], []
    for i in range(0, b, step):
        part = slice(i, i + step)
        with st("width maps, pass 1"):
            edge_cls = S._edge_classes(edges[part], gx[part], gy[part])
            chains, maps, a_enc = S._width_pass(edge_cls, max_len)
        with st("ray medians"):
            med_map = {s: S._ray_medians(maps[s], a_enc[s]) for s in (-1, 1)}
        with st("width maps, pass 2"):
            res = S._median_pass(edge_cls, chains, maps, med_map, max_len)
        with st(KERNEL_STAGE):
            S._swt_maps_one(None, edges[part], gx[part], gy[part], max_len)
        minus.append(res[-1])
        plus.append(res[1])
        del edge_cls, chains, maps, a_enc, med_map, res
    del gx, gy
    minus, plus = torch.cat(minus), torch.cat(plus)
    max_runs, max_letters = max(h * w // 32, 1024), max(h * w // 2048, 1024)
    valid, links = [], {d: [] for d in S.OFFSETS}
    with st("labelling"):  # links and labels alone, as the letter pass makes them
        med = S._median_gray(gray)
        for i in range(b):
            neg = gray[i] < med[i]
            sw = torch.where(neg, minus[i], torch.where(
                gray[i] > med[i], plus[i], S._INF))
            ok = sw < S._INF
            page_links = S._letter_links(sw, ok, neg)
            label_components_links(ok[None], page_links)
            if keep_links:
                valid.append(ok[None])
                for d in S.OFFSETS:
                    links[d].append(page_links[d])
            del neg, sw, ok, page_links
    with st("letter pass (labelling included)"):
        letter, boxes, boxes_ok, n_runs, n_letters = S._letter_mask(
            gray, minus, plus, max_letters, max_runs)
    del minus, plus
    with st("output"):
        alpha = words & -0x1000000
        out = S._gray_word(torch.where(
            letter, torch.zeros_like(words), 255), alpha)
    both = st.ms.pop("letter pass (labelling included)")
    st.ms["letter statistics"] = (both - st.ms["labelling"] if st.on_card
                                  else timing.NOT_MEASURED)
    return {"ms": st.ms, "gray": gray, "strong": strong, "weak": weak,
            "valid": torch.cat(valid) if keep_links else None,
            "links": {d: torch.cat(v) for d, v in links.items()}
            if keep_links else None,
            "letter": letter, "boxes": boxes, "boxes_ok": boxes_ok,
            "n_runs": n_runs, "n_letters": n_letters, "max_runs": max_runs,
            "max_letters": max_letters, "out": out}


def measure(b: int = 1, h: int = timing.A4[0], w: int = timing.A4[1],
            iters: int = 2, device=None) -> dict:
    dev = timing.device(device)
    words = pages_to_words(torch.from_numpy(text_pages(b, h, w)).to(dev))
    p = timing.Profile("profile_swt", dev, (b, h, w), iters)
    # a fresh process's first calls load the kernels and set up the
    # libraries: one call of swt first, so that the stages read steady
    S.swt(words)
    timing.sync(dev)
    stages = swt_stages(words)
    for label, ms in stages["ms"].items():
        p.put(label, None if ms == timing.NOT_MEASURED else ms / 1e3)
    p.total("sum of stages", [k for k in stages["ms"] if k != KERNEL_STAGE])
    p.stage("swt total (mode 0)", S.swt, words)
    p.rec["letters_per_page"] = stages["n_letters"].tolist()
    return p.rec


def main() -> None:
    print(f"wrote {timing.write('profile_swt', measure())}")


if __name__ == "__main__":
    main()
