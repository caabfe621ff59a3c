"""The shared edge cases of the component labels
(`utils.pages.label_cases`): the plain PyTorch labels against the JAX
package on the CPU, its XLA rounds and, where a case is 8-connected, the
TPU kernel `_label_sweep_kernel` in interpret mode. The CUDA kernel is
held to the same cases, against this plain version, by chip_smoke.py on
the card.

A file of its own, so that the test runner can give it to another worker
than the other kernel tests: every case compiles the reference anew."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpillowfight_tpu.ops import morph as jmorph
from libpillowfight_tpu.ops.pallas.flood_kernel import label_components_pallas
from libpillowfight_tpu_torch.ops import morph as tmorph
from libpillowfight_tpu_torch.ops.cuda import label as tlabel
from libpillowfight_tpu_torch.utils.pages import (LABEL_CASE_NAMES,
                                                  LABEL_OFFSETS, label_cases)

torch.set_num_threads(1)  # small planes, beside other workers' compiles


def _between_valid(valid, links):
    """The links inside the reference's domain: set only between two
    valid pixels of the page (the port drops the others itself)."""
    h, w = valid.shape[1:]
    out = {}
    for (dy, dx), link in links.items():
        other = np.zeros_like(valid)
        other[:, :h - dy, max(0, -dx):w - max(0, dx)] = \
            valid[:, dy:, max(0, dx):w + min(0, dx)]
        out[(dy, dx)] = link & valid & other
    return out


@pytest.mark.parametrize("case", range(len(LABEL_CASE_NAMES)),
                         ids=LABEL_CASE_NAMES)
def test_label_edge_cases_plain_vs_reference(case):
    """The edge cases the CUDA label kernel is held to on the card
    (heights and widths around its 64 x 32 tile and its 4- and 16-byte
    loads, snakes and a spiral across tile borders, a least index in the
    last tile, diagonal-only links, links off the page or to invalid
    pixels, empty, full and solid planes, one to three pages): the plain
    labels against the reference, bit-identical."""
    name, valid, links = label_cases()[case]
    b, h, w = valid.shape
    tv = torch.from_numpy(valid)
    if links is None:
        want = np.asarray(jmorph.label_components(jnp.asarray(valid)))
        np.testing.assert_array_equal(
            np.asarray(label_components_pallas(jnp.asarray(valid),
                                               interpret=True)), want)
        got = tmorph.label_components(tv).numpy()
    else:
        want = np.asarray(jmorph.label_components_links(
            jnp.asarray(valid),
            {d: jnp.asarray(v)
             for d, v in _between_valid(valid, links).items()}))
        got = tmorph.label_components_links(
            tv, {d: torch.from_numpy(v) for d, v in links.items()}).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == h * w).all() and (got[valid] < h * w).all()
    flat = np.arange(h * w).reshape(1, h, w)
    roots = (got == flat).sum(axis=(1, 2))  # components a page
    if name in ("snake_rows", "snake_columns", "spiral", "least_index_last",
                "full_8conn", "full_links"):
        assert roots.tolist() == [1]
    if name == "least_index_last":
        assert got[0, -1, -3] == 2  # the hook's far end: column 2 of row 0
    if name == "diagonals_only":
        assert roots.tolist() == [2]  # the two colours of a chessboard
    if name == "empty":
        assert roots.tolist() == [0]
    if name == "solid_blocks_b3":
        assert roots.tolist() == [1, 1, 2]


def test_label_cases_cover_the_tile():
    """The cases name the kernel's own tile and link order, so that a
    change of either shows here."""
    from libpillowfight_tpu_torch.utils import pages

    assert LABEL_OFFSETS == tlabel.OFFSETS
    assert (pages.LABEL_TILE_H, pages.LABEL_TILE_W) == (32, 64)
    cases = label_cases()
    assert len(cases) >= 12
    assert {c[1].shape[0] for c in cases} == {1, 2, 3}
    assert all(max(c[1].shape[1:]) <= 200 for c in cases)
