"""The page generator: the same pages from the same seed, other pages
from another seed or index."""

import numpy as np
import pytest

from benchmark.harness import load_cell
from benchmark.pages import make_pages

CONTENT = {name: load_cell(name).params["content"]
           for name in ("cleanup-a4-300-resident", "ocr-prep-a4-300-files")}
BIG = 2**31 + 123457


@pytest.mark.parametrize("kind", sorted(CONTENT))
def test_same_seed_same_pages(kind):
    a = make_pages(BIG, 0, 3, 700, 500, 300, CONTENT[kind])
    b = make_pages(BIG, 0, 3, 700, 500, 300, CONTENT[kind])
    assert np.array_equal(a, b)
    assert np.array_equal(make_pages(BIG, 2, 1, 700, 500, 300,
                                     CONTENT[kind])[0], a[2])


@pytest.mark.parametrize("kind", sorted(CONTENT))
def test_other_seed_or_index_other_pages(kind):
    a = make_pages(BIG, 0, 3, 700, 500, 300, CONTENT[kind])
    b = make_pages(BIG + 1, 0, 3, 700, 500, 300, CONTENT[kind])
    for i in range(3):
        assert (a[i] != b[i]).mean() > 0.01
        for j in range(i):
            assert (a[i] != a[j]).mean() > 0.01
    assert (a[..., 3] == 255).all()
