"""Version of the package (port of `libpillowfight_tpu/version.py`).

The same version as the reference: both packages ship in the one
`libpillowfight-tpu` distribution. Resolved at import: the installed
distribution's version if present, else `git describe` of the working
tree, else the static default.
"""

from __future__ import annotations

import os
import subprocess

__version__ = "0.3.0.tpu1"


def get_version() -> str:
    try:
        from importlib.metadata import version

        return version("libpillowfight-tpu")
    except Exception:
        pass
    try:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run(
            ["git", "describe", "--tags", "--always", "--dirty"],
            cwd=root, capture_output=True, text=True, timeout=5,
        )
        if out.returncode == 0 and out.stdout.strip():
            return f"{__version__}+{out.stdout.strip()}"
    except Exception:
        pass
    return __version__
