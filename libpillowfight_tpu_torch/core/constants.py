"""The constants of the ported filters.

A copy of `libpillowfight_tpu/core/constants.py` (the pixel model,
gaussian, canny, ACE, SWT, unpaper and compare sections): importing the
reference module runs its package `__init__`, which imports jax. A test
pins every value here equal to the reference's.
"""

PF_WHITE = 0xFF
PF_BLACK = 0x00

# gray is the unweighted channel mean, (r + g + b) / 3
GRAYSCALE_MODE = "mean"

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

SWT_OUTPUT_BW_TEXT = 0
SWT_OUTPUT_GRAYSCALE_TEXT = 1
SWT_OUTPUT_ORIGINAL_BOXES = 2

SWT_MAX_RAY_LEN = 128          # bound of a ray, in pixels
SWT_RAY_ANGLE_TOLERANCE = 0.5235987755982988  # pi/6: opposing-gradient cone
SWT_CC_SW_RATIO = 3.0          # connect pixels whose SW ratio <= 3
SWT_LETTER_VARIANCE_RATIO = 0.5    # var(sw) <= ratio * mean(sw)^2 is kept
SWT_LETTER_ASPECT_RATIO_MAX = 10.0
SWT_LETTER_DIAMETER_SW_RATIO = 10.0  # diag / mean_sw < 10
SWT_LETTER_HEIGHT_MIN = 10
SWT_LETTER_HEIGHT_MAX = 300
SWT_LETTER_MIN_PIXELS = 38     # reject tiny components
SWT_MAX_NESTED_LETTERS = 2     # > 2 nested boxes: a frame, not a letter

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

COMPARE_DEFAULT_TOLERANCE = 0  # largest channel difference that still matches
