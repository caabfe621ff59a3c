"""Drop-in `pillowfight` module over the PyTorch + CUDA port (ref:
src/pillowfight/__init__.py: `import pillowfight; pillowfight.ace(img)`).

Existing pypillowfight user code runs unmodified against the port with
`import pillowfight_torch as pillowfight`: this shim re-exports the
façade of `libpillowfight_tpu_torch.compat` (PIL.Image in -> PIL.Image
out, the reference's public names, enums and defaults). Each function
runs on the first CUDA card; pass `device="cpu"` to run on the CPU.
"""

from libpillowfight_tpu_torch.compat import (  # noqa: F401
    SWT_OUTPUT_BW_TEXT,
    SWT_OUTPUT_GRAYSCALE_TEXT,
    SWT_OUTPUT_ORIGINAL_BOXES,
    __all__,
    ace,
    canny,
    compare,
    gaussian,
    get_version,
    sobel,
    swt,
    unpaper_blackfilter,
    unpaper_blurfilter,
    unpaper_border,
    unpaper_grayfilter,
    unpaper_masks,
    unpaper_noisefilter,
)
