"""Every module of the reference package against its counterpart in the
port: public names and `__all__`, except what ROADMAP.md's "Not to be
ported" table lists; `core`'s re-exports, `GRAYSCALE_MODE`, and
`block_sums` against the JAX `block_sums`."""

import importlib
import inspect
import pkgutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpillowfight_tpu as pf
import libpillowfight_tpu_torch as pt
from libpillowfight_tpu.ops.unpaper import common as jcommon
from libpillowfight_tpu_torch.ops.unpaper import common as tcommon

torch.set_num_threads(1)

# Modules of the reference with no counterpart module (ROADMAP.md "Not to
# be ported"): the Pallas kernels, whose counterparts are `ops/cuda/` and
# `csrc/`, held by the kernel tests.
NO_COUNTERPART = ("libpillowfight_tpu.ops.pallas",)
# Names of the table's rows, wherever the reference exports them.
# `pallas_backend_ok` asks whether Pallas kernels can run on JAX's backend;
# the port's wrappers choose by each tensor's device and ask no backend.
NOT_PORTED = {
    "pallas", "pallas_backend_ok",
    "put_row_major", "row_major_format",
}

REF_MODULES = ["libpillowfight_tpu"] + sorted(
    m.name for m in pkgutil.walk_packages(pf.__path__, "libpillowfight_tpu.")
    if not m.name.startswith(NO_COUNTERPART))


def _public(mod) -> set:
    """What a module defines for its users: the functions and classes
    defined in it and its other values (constants); not what it imports
    (jax, jnp, typing, functions of other modules). Submodules are not
    counted here (which of them a package holds as attributes depends on
    what was imported before): each is a module of REF_MODULES itself."""
    out = set()
    for name, value in vars(mod).items():
        if (name.startswith("_") or name == "annotations"
                or isinstance(value, types.ModuleType)):
            continue
        if inspect.isfunction(value) or inspect.isclass(value):
            if value.__module__ == mod.__name__:
                out.add(name)
        elif not callable(value):
            out.add(name)
    return out - NOT_PORTED


def _port(name: str):
    return importlib.import_module(
        name.replace("libpillowfight_tpu", "libpillowfight_tpu_torch", 1))


def test_every_module_is_walked():
    assert len(REF_MODULES) >= 25
    assert "libpillowfight_tpu.utils.oracle" in REF_MODULES


@pytest.mark.parametrize("name", REF_MODULES)
def test_public_names_match_reference(name):
    ref = importlib.import_module(name)
    port = _port(name)
    missing = sorted(n for n in _public(ref) if not hasattr(port, n))
    assert missing == [], f"{port.__name__} lacks {missing}"


@pytest.mark.parametrize("name", [n for n in REF_MODULES if hasattr(
    importlib.import_module(n), "__all__")])
def test_all_covers_reference(name):
    ref_all = [n for n in importlib.import_module(name).__all__
               if n not in NOT_PORTED]
    port = _port(name)
    assert hasattr(port, "__all__"), f"{port.__name__} has no __all__"
    assert set(ref_all) <= set(port.__all__)
    for n in port.__all__:
        assert hasattr(port, n), n


def test_core_reexports_bitmap():
    assert pt.core.__all__ == pf.core.__all__
    assert pt.core.constants is importlib.import_module(
        "libpillowfight_tpu_torch.core.constants")
    for n in pf.core.__all__[1:]:
        assert getattr(pt.core, n) is getattr(pt.core.bitmap, n), n
    from libpillowfight_tpu_torch.core import compare, to_pil, write_ppm
    assert (compare, to_pil, write_ppm) == (pt.core.bitmap.compare,
                                            pt.core.bitmap.to_pil,
                                            pt.core.bitmap.write_ppm)


def test_grayscale_mode():
    from libpillowfight_tpu.core import constants as JC
    from libpillowfight_tpu_torch.core import constants as TC
    assert TC.GRAYSCALE_MODE == JC.GRAYSCALE_MODE == "mean"


def test_utils_exports_oracle():
    assert pt.utils.__all__ == pf.utils.__all__ == ["oracle"]
    assert pt.utils.oracle.__name__ == "libpillowfight_tpu_torch.utils.oracle"


# (size, step) of the chain's filters (blackfilter, blurfilter, grayfilter,
# masks, border), one with step > size, one wider than the plane
SIZES = [(20, 5), (100, 50), (50, 20), (50, 5), (5, 5), (3, 7), (300, 5)]


def _planes(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (2, 257, 263)
    if kind == "bool":
        return rng.random(shape) < 0.3
    if kind == "int_f32":  # s3-like sums r+g+b, exact in f32
        return rng.integers(0, 766, shape).astype(np.float32)
    return rng.random(shape, dtype=np.float32)


@pytest.mark.parametrize("size,step", SIZES)
@pytest.mark.parametrize("kind", ["bool", "int_f32", "f32"])
def test_block_sums_matches_jax(kind, size, step):
    x = _planes(kind)
    want = np.asarray(jcommon.block_sums(jnp.asarray(x), size, step))
    got = tcommon.block_sums(torch.from_numpy(x), size, step)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    if kind == "f32":  # the summation order differs from XLA's
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
