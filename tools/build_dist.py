"""Build distribution artifacts: wheel + one-file .pyz executable.

The reference ships PyInstaller one-file executables
(/root/reference/build.spec:5-65). The modern Python analogs here:

* a wheel (``pip wheel``) with console scripts ``amr`` / ``amr-app``
  / ``amr-tui`` / ``amr-gui`` and the NEURAL codebook bundled as
  package data, and
* a stdlib ``zipapp`` one-file executable ``amr.pyz`` (runs with any
  Python that has the jax/numpy runtime installed: ``python amr.pyz
  encode-file ...``).

Usage::

    python tools/build_dist.py [--out dist/]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import zipapp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_wheel(out_dir: str) -> str:
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "-w", out_dir, REPO],
        check=True,
    )
    wheels = [f for f in os.listdir(out_dir) if f.endswith(".whl")]
    return os.path.join(out_dir, sorted(wheels)[-1])


def build_pyz(out_dir: str) -> str:
    target = os.path.join(out_dir, "amr.pyz")
    with tempfile.TemporaryDirectory() as stage:
        shutil.copytree(
            os.path.join(REPO, "audio_modem_radio"),
            os.path.join(stage, "audio_modem_radio"),
            ignore=shutil.ignore_patterns("__pycache__"),
        )
        with open(os.path.join(stage, "__main__.py"), "w") as f:
            f.write("from audio_modem_radio.cli import main\n"
                    "import sys\n"
                    "sys.exit(main())\n")
        zipapp.create_archive(stage, target, interpreter="/usr/bin/env python3")
    return target


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(REPO, "dist"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    wheel = build_wheel(args.out)
    pyz = build_pyz(args.out)
    print(f"wheel: {wheel}")
    print(f"pyz:   {pyz}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
