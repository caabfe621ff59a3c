"""The constants of the ported filters.

A copy of `libpillowfight_tpu/core/constants.py` (the gaussian, canny,
ACE and unpaper sections): importing the reference module runs its
package `__init__`, which imports jax. A test pins every value here
equal to the reference's.
"""

PF_WHITE = 0xFF

GAUSSIAN_DEFAULT_SIGMA = 2.0
GAUSSIAN_DEFAULT_NB_STDDEV = 5   # 1-D half-width ceil(sigma * nb_stddev)

CANNY_GAUSSIAN_SIGMA = 2.0
CANNY_GAUSSIAN_NB_STDDEV = 5
CANNY_LOW_THRESHOLD_FRACTION = 0.47 / 2.0  # of the per-page peak
CANNY_HIGH_THRESHOLD_FRACTION = 0.47

ACE_DEFAULT_NB_SAMPLES = 100
ACE_DEFAULT_SLOPE = 10.0
ACE_DEFAULT_LIMIT = 1000.0
ACE_DEFAULT_NB_THREADS = 2  # kept for API parity; ignored
ACE_DEFAULT_SEED = 0xACE5EED

UNPAPER_BLACK_THRESHOLD = 0.33   # pixel is "black" if gray < 0.33 * 255
UNPAPER_WHITE_THRESHOLD = 0.9    # pixel is "non-white" if gray < 0.9 * 255

BLACKFILTER_SCAN_SIZE = 20
BLACKFILTER_SCAN_STEP = 5
BLACKFILTER_SCAN_THRESHOLD = 0.95   # square "blackness" ratio to trigger fill
BLACKFILTER_INTENSITY = 20          # flood gap-leap radius (px)

NOISEFILTER_INTENSITY = 4   # clusters of <= 4 non-white pixels are erased

BLURFILTER_SIZE = 100
BLURFILTER_STEP = 50
BLURFILTER_INTENSITY = 0.01  # max dark ratio for a block to be "clean"

GRAYFILTER_SIZE = 50
GRAYFILTER_STEP = 20
GRAYFILTER_THRESHOLD = 0.5

MASKS_SCAN_SIZE = 50
MASKS_SCAN_STEP = 5
MASKS_SCAN_THRESHOLD = 0.1  # strip dark-ratio below which content has ended

BORDER_SCAN_SIZE = 5
BORDER_SCAN_STEP = 5
BORDER_SCAN_THRESHOLD = 5  # dark-pixel COUNT above which a strip has content
