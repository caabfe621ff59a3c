"""Each unpaper filter's decision core in the port vs the JAX one, on
pages whose height and width are multiples of no scan step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from libpillowfight_tpu.ops import morph as jmorph
from libpillowfight_tpu.ops.unpaper import (blackfilter as jblack,
                                            blurfilter as jblur,
                                            border as jborder,
                                            grayfilter as jgray,
                                            masks as jmasks,
                                            noisefilter as jnoise)
from libpillowfight_tpu_torch.core import bitmap as tbm
from libpillowfight_tpu_torch.ops import morph as tmorph
from libpillowfight_tpu_torch.ops.unpaper import (blackfilter as tblack,
                                                  blurfilter as tblur,
                                                  border as tborder,
                                                  common as tcommon,
                                                  grayfilter as tgray,
                                                  masks as tmasks,
                                                  noisefilter as tnoise)

H, W = 263, 347


@pytest.fixture(scope="module")
def planes():
    pages = bench._pages(2, H, W, seed=3)
    pages[0, :, :25, :3] = 0                         # black scan border
    pages[0, 100:103, :25, :3] = 245                 # broken by a 3-row gap
    pages[0, 60:64, 25:200, :3] = 10                 # bar attached to it
    pages[1, 150:230, 200:300, :3] = 205            # light shading block
    pages[1, 20:24, 300:304, :3] = 120              # lonely smudge
    words = torch.from_numpy(pages).view(torch.int32).squeeze(-1)
    gray = tbm.words_to_gray(words)
    dark = tcommon.dark_mask(gray)
    nonwhite = tcommon.nonwhite_mask(gray)
    s3 = tbm.words_to_s3(words)
    quiet = torch.zeros((2, H, W), dtype=torch.bool)  # speckle-free plane
    quiet[0, 50:53, 40:300] = True                   # a text line
    quiet[0, 200:203, 150:155] = True                # a smudge near it
    quiet[1, 20:24, 300:304] = True                  # lonely smudges
    quiet[1, 180:181, 30:33] = True
    return {"gray": gray, "dark": dark, "nonwhite": nonwhite, "s3": s3,
            "quiet": quiet}


def _j(t):
    return jnp.asarray(t.numpy())


CORES = {
    "blackfilter": (lambda p: tblack.blackfilter_wipe_dark(p["dark"]),
                    lambda p: jblack.blackfilter_wipe_dark(_j(p["dark"]))),
    "blackfilter_leap3": (
        lambda p: tblack.blackfilter_wipe_dark(p["dark"], intensity=3),
        lambda p: jblack.blackfilter_wipe_dark(_j(p["dark"]), intensity=3)),
    "noisefilter": (lambda p: tnoise.noisefilter_wipe_nonwhite(p["nonwhite"]),
                    lambda p: jnoise.noisefilter_wipe_nonwhite(
                        _j(p["nonwhite"]))),
    "noisefilter_k1": (
        lambda p: tnoise.noisefilter_wipe_nonwhite(p["nonwhite"], 1),
        lambda p: jnoise.noisefilter_wipe_nonwhite(_j(p["nonwhite"]), 1)),
    "blurfilter_quiet": (
        lambda p: tblur.blurfilter_wipe_nonwhite(p["quiet"]),
        lambda p: jblur.blurfilter_wipe_nonwhite(_j(p["quiet"]))),
    "blurfilter_small": (
        lambda p: tblur.blurfilter_wipe_nonwhite(p["quiet"], 30, 7, 0.05),
        lambda p: jblur.blurfilter_wipe_nonwhite(_j(p["quiet"]), 30, 7,
                                                 0.05)),
    "masks": (lambda p: tmasks.masks_wipe_dark(p["dark"]),
              lambda p: jmasks.masks_wipe_dark(_j(p["dark"]))),
    "masks_starts": (
        lambda p: tmasks.masks_wipe_dark(p["dark"],
                                         starts=((60, 80), (200, 300), (5, 2))),
        lambda p: jmasks.masks_wipe_dark(_j(p["dark"]),
                                         starts=((60, 80), (200, 300), (5, 2)))),
    "grayfilter_s3": (
        lambda p: tgray.grayfilter_wipe_planes_s3(p["dark"], p["s3"]),
        lambda p: jgray.grayfilter_wipe_planes_s3(
            _j(p["dark"]), _j(p["s3"]).astype(jnp.uint16))),
    "grayfilter_f32_shim": (
        lambda p: tgray.grayfilter_wipe(p["gray"], threshold=0.3),
        lambda p: jgray.grayfilter_wipe(_j(p["gray"]), threshold=0.3)),
    "border": (lambda p: tborder.border_wipe_dark(p["quiet"]),
               lambda p: jborder.border_wipe_dark(_j(p["quiet"]))),
    "border_wide": (lambda p: tborder.border_wipe_dark(p["dark"], 9, 4, 40),
                    lambda p: jborder.border_wipe_dark(_j(p["dark"]), 9, 4, 40)),
    "dilate_cheb": (lambda p: tmorph.dilate_cheb(p["nonwhite"], 3),
                    lambda p: jmorph.dilate_cheb(_j(p["nonwhite"]), 3)),
    "flood_reach_leap2": (
        lambda p: tmorph.flood_reach(p["dark"] & (torch.rand(
            p["dark"].shape, generator=torch.Generator().manual_seed(0)) < 0.01),
            p["nonwhite"], leap=2),
        lambda p: jmorph.flood_reach(_j(p["dark"] & (torch.rand(
            p["dark"].shape, generator=torch.Generator().manual_seed(0)) < 0.01)),
            _j(p["nonwhite"]), leap=2)),
}


@pytest.mark.parametrize("name", sorted(CORES))
def test_decision_core_matches_jax(planes, name):
    port, ref = CORES[name]
    got = port(planes)
    want = np.asarray(jax.jit(lambda: ref(planes))())
    assert got.dtype == torch.bool and got.shape == (2, H, W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.any()  # the case exercises a wipe


@pytest.mark.parametrize("name", ["unpaper_blackfilter", "unpaper_noisefilter",
                                  "unpaper_blurfilter", "unpaper_masks",
                                  "unpaper_grayfilter", "unpaper_border"])
def test_single_filter_entry_matches_jax(page, name):
    from libpillowfight_tpu.ops import unpaper as junpaper
    from libpillowfight_tpu_torch.ops import unpaper as tunpaper

    want = np.asarray(jax.jit(getattr(junpaper, name))(jnp.asarray(page)))
    got = getattr(tunpaper, name)(torch.from_numpy(page)).numpy()
    np.testing.assert_array_equal(got, want)
