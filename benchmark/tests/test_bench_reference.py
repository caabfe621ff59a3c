"""The frozen plain reference against the program's plain CPU versions
on small pages: the same words, filter by filter and whole."""

import pytest
import torch

import libpillowfight_tpu_torch as pt
from benchmark import reference
from benchmark.harness import load_cell
from benchmark.pages import make_pages

torch.set_num_threads(4)
CLEANUP = load_cell("cleanup-a4-300-resident")
OCR = load_cell("ocr-prep-a4-300-files")


def words(cell, seed, n=2, h=420, w=330):
    pages = make_pages(seed, 0, n, h, w, 300, cell.params["content"])
    return torch.from_numpy(pages).view(torch.int32).squeeze(-1)


@pytest.mark.parametrize("i", range(6))
def test_each_unpaper_filter(i):
    item = CLEANUP.config["spec"][i]
    x = words(CLEANUP, 10 + i)
    want = pt.run_pipeline(x, pt.normalize_spec([item]))
    assert torch.equal(reference.run(x, [item]), want)


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
@pytest.mark.parametrize("cell", [CLEANUP, OCR], ids=["cleanup", "ocr"])
def test_whole_spec(cell, seed):
    x = words(cell, seed)
    want = pt.run_pipeline(x, pt.normalize_spec(cell.config["spec"]))
    got = reference.run(x, cell.config["spec"])
    assert torch.equal(got, want)


@pytest.mark.parametrize("output_type", [0, 1, 2])
def test_swt_finds_the_letters_the_program_finds(output_type):
    x = words(OCR, 5, n=1, h=500, w=400)
    want = pt.swt(x, output_type)
    got = reference.swt(x, output_type)
    assert torch.equal(got, want)
    if output_type == 0:
        assert int(((got & 0xFF) == 0).sum()) > 1000  # letters were found
