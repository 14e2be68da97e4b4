"""Build a fully self-contained one-file executable: ``amr.run``.

The reference ships PyInstaller one-file executables that bundle the whole
Python runtime (/root/reference/build.spec:5-65, FileBeepAdvanced.spec:6-10).
``tools/build_dist.py``'s zipapp is one file but still needs a jax-equipped
host Python; this tool closes that capability delta: the ``.run`` artifact
embeds the CPython interpreter, the standard library, the jax/numpy runtime,
the package and its native C++ helper into ONE self-extracting POSIX shell
script. Copy it to any Linux host of the same architecture and run it — no
Python, no pip, no network.

Mechanics (the makeself pattern, stdlib-only):

* a short ``sh`` launcher header ends at an ``__ARCHIVE__`` marker; the
  bytes after the marker are a ``tar.gz`` of a relocatable prefix
  (``bin/python3.x``, ``lib/libpython*.so*`` + non-glibc shared-library
  closure, ``lib/python3.x/`` stdlib, ``lib/python3.x/site-packages/`` with
  the dependency set and the package).
* first run extracts to ``~/.cache/amr-standalone/<sha256[:16]>`` (or
  ``$AMR_HOME``); later runs reuse the extracted tree (the digest keys
  the cache, so upgraded artifacts never collide).
* the launcher ``exec``s the bundled interpreter on the chosen entry module
  with ``PYTHONHOME``/``LD_LIBRARY_PATH`` pointing into the prefix. CPython
  also finds the prefix by its own binary-relative landmark search, so the
  tree is fully relocatable.

Only glibc itself (libc/libm/ld-linux) is taken from the host — the same
contract as the reference's PyInstaller onefile builds.

Usage::

    python tools/build_standalone.py [--out dist/] [--deps jax,jaxlib,...]
        [--level 6]

The default dependency set is the package's hard runtime closure (lazy
optional extras — flax/optax training, sounddevice, serial — are gated in
the package and degrade gracefully when absent; add them with ``--deps``).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import tarfile
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Hard runtime closure of audio_modem_radio (everything else is a lazy,
# gated import with a working fallback — see COMPAT.md "optional extras").
DEFAULT_DEPS = (
    "jax",
    "jaxlib",
    "ml_dtypes",
    "opt_einsum",
    "numpy",
    "scipy",
)

# glibc core: must come from the target host (bundling ld-linux/libc is the
# line where "portable prefix" becomes "container"); everything else the
# interpreter or its extension modules link against ships in lib/.
_GLIBC = (
    "libc.so", "libm.so", "libdl.so", "libpthread.so", "librt.so",
    "libutil.so", "libresolv.so", "libnsl.so", "ld-linux",
    "linux-vdso", "libmvec.so",
)

_LAUNCHER = """#!/bin/sh
# amr standalone executable (self-extracting; built by
# tools/build_standalone.py). Everything after __ARCHIVE__ is a tar.gz
# prefix with a bundled CPython + jax runtime.
set -e
SUM=%(digest)s
PYBIN=%(pybin)s
ENTRY=%(entry)s
BASE="${AMR_HOME:-${XDG_CACHE_HOME:-$HOME/.cache}/amr-standalone}"
DIR="$BASE/$SUM"
if [ ! -x "$DIR/bin/$PYBIN" ]; then
    TMP="$BASE/.extract.$$"
    mkdir -p "$TMP"
    LINE=$(awk '/^__ARCHIVE__$/{print NR+1; exit 0}' "$0")
    tail -n +"$LINE" "$0" | gzip -dc | tar -xf - -C "$TMP"
    # Atomic install: $DIR only ever appears via rename, so an interrupted
    # or concurrent extraction can never leave a partial prefix behind
    # (the race loser just discards its temp tree).
    mv "$TMP" "$DIR" 2>/dev/null || rm -rf "$TMP"
fi
export PYTHONHOME="$DIR"
export LD_LIBRARY_PATH="$DIR/lib${LD_LIBRARY_PATH:+:$LD_LIBRARY_PATH}"
exec "$DIR/bin/$PYBIN" -m "$ENTRY" "$@"
__ARCHIVE__
"""


def _ignore(*names: str):
    return shutil.ignore_patterns("__pycache__", "*.pyc", "*.a", *names)


def _ldd_closure(binaries) -> dict:
    """Resolved non-glibc shared-library deps of ``binaries`` (name -> path)."""
    out: dict = {}
    for b in binaries:
        try:
            txt = subprocess.run(
                ["ldd", b], capture_output=True, text=True, timeout=60
            ).stdout
        except (subprocess.SubprocessError, FileNotFoundError):
            continue
        for line in txt.splitlines():
            if "=>" not in line:
                continue
            name, _, rest = line.strip().partition(" => ")
            path = rest.split(" (")[0].strip()
            if not path or not os.path.exists(path):
                continue
            if any(g in name for g in _GLIBC):
                continue
            out.setdefault(os.path.basename(path), os.path.realpath(path))
    return out


def _copy_runtime(stage: str) -> str:
    """Bundle the interpreter, libpython + .so closure, and the stdlib."""
    pybin = os.path.realpath(sys.executable)
    pyname = os.path.basename(pybin)
    os.makedirs(os.path.join(stage, "bin"), exist_ok=True)
    shutil.copy2(pybin, os.path.join(stage, "bin", pyname))

    stdlib = sysconfig.get_paths()["stdlib"]  # base prefix, not the venv
    short = f"python{sys.version_info[0]}.{sys.version_info[1]}"
    dest = os.path.join(stage, "lib", short)
    shutil.copytree(
        stdlib, dest,
        ignore=_ignore("test", "tests", "idlelib", "ensurepip", "config-3*"),
        symlinks=False,
    )

    dynload = os.path.join(dest, "lib-dynload")
    ext_sos = (
        [os.path.join(dynload, f) for f in os.listdir(dynload)]
        if os.path.isdir(dynload) else []
    )
    for name, path in _ldd_closure([pybin] + ext_sos).items():
        shutil.copy2(path, os.path.join(stage, "lib", name))
    return pyname


def _locate_dist(name: str) -> str:
    """Top-level import path for ``name`` in the current environment."""
    import importlib.util

    spec = importlib.util.find_spec(name)
    if spec is None:
        raise SystemExit(f"dependency {name!r} is not importable in this environment")
    if spec.submodule_search_locations:
        return list(spec.submodule_search_locations)[0]
    return spec.origin  # single-module dist


def _copy_deps(stage: str, deps) -> None:
    short = f"python{sys.version_info[0]}.{sys.version_info[1]}"
    sp = os.path.join(stage, "lib", short, "site-packages")
    os.makedirs(sp, exist_ok=True)
    for name in deps:
        src = _locate_dist(name)
        if os.path.isdir(src):
            shutil.copytree(
                src, os.path.join(sp, os.path.basename(src)),
                ignore=_ignore("tests", "*.h", "*.pxd"), symlinks=False,
            )
            # auditwheel-vendored shared libraries live in a SIBLING
            # "<dist>.libs/" directory resolved via $ORIGIN rpaths
            # (numpy.libs, scipy.libs, ...) — ship it alongside.
            libs = src + ".libs"
            if not os.path.isdir(libs):
                libs = os.path.join(
                    os.path.dirname(src), name.replace("-", "_") + ".libs"
                )
            if os.path.isdir(libs):
                shutil.copytree(
                    libs, os.path.join(sp, os.path.basename(libs)),
                    symlinks=False,
                )
        else:
            shutil.copy2(src, sp)


def _copy_app(stage: str) -> None:
    short = f"python{sys.version_info[0]}.{sys.version_info[1]}"
    sp = os.path.join(stage, "lib", short, "site-packages")
    os.makedirs(sp, exist_ok=True)
    shutil.copytree(
        os.path.join(REPO, "audio_modem_radio"),
        os.path.join(sp, "audio_modem_radio"),
        ignore=_ignore(), symlinks=False,
    )
    # native.py resolves <package parent>/native/{amr_native.cpp,libamr_native.so};
    # ship the prebuilt .so with a fresh mtime so the source-newer rebuild
    # check never fires on a host without a toolchain.
    nat_src = os.path.join(REPO, "native")
    nat_dst = os.path.join(sp, "native")
    if os.path.isdir(nat_src):
        shutil.copytree(nat_src, nat_dst, ignore=_ignore(), symlinks=False)
        so = os.path.join(nat_dst, "libamr_native.so")
        if os.path.exists(so):
            os.utime(so)


def build_standalone(
    out_path: str,
    deps=DEFAULT_DEPS,
    entry: str = "audio_modem_radio.cli",
    include_app: bool = True,
    stage_hook=None,
    level: int = 6,
) -> str:
    """Assemble the prefix, tar it, and emit the self-extracting script.

    ``stage_hook(stage_dir, site_packages_dir)`` lets tests inject a tiny
    entry package instead of the full app.
    """
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out_path) or ".") as tmp:
        stage = os.path.join(tmp, "prefix")
        os.makedirs(stage)
        pyname = _copy_runtime(stage)
        _copy_deps(stage, deps)
        if include_app:
            _copy_app(stage)
        if stage_hook is not None:
            short = f"python{sys.version_info[0]}.{sys.version_info[1]}"
            sp = os.path.join(stage, "lib", short, "site-packages")
            os.makedirs(sp, exist_ok=True)
            stage_hook(stage, sp)

        tar_path = os.path.join(tmp, "prefix.tar.gz")
        with tarfile.open(tar_path, "w:gz", compresslevel=level) as tf:
            for name in sorted(os.listdir(stage)):
                tf.add(os.path.join(stage, name), arcname=name)

        digest = hashlib.sha256()
        with open(tar_path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)

        header = _LAUNCHER % {
            "digest": digest.hexdigest()[:16],
            "pybin": pyname,
            "entry": entry,
        }
        with open(out_path, "wb") as out:
            out.write(header.encode())
            with open(tar_path, "rb") as f:
                shutil.copyfileobj(f, out)
        os.chmod(out_path, 0o755)
    return out_path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(REPO, "dist"))
    ap.add_argument("--deps", default=",".join(DEFAULT_DEPS),
                    help="comma-separated site-packages distributions to bundle")
    ap.add_argument("--entry", default="audio_modem_radio.cli")
    ap.add_argument("--level", type=int, default=6, help="gzip level (1-9)")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, "amr.run")
    deps = [d for d in args.deps.split(",") if d]
    build_standalone(out_path, deps=deps, entry=args.entry, level=args.level)
    size = os.path.getsize(out_path)
    print(f"built {out_path} ({size / 1e6:.1f} MB, deps={deps})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
