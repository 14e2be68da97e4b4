"""Self-contained .run executable (tools/build_standalone.py).

Builds a minimal bundle (interpreter + stdlib + an injected probe module,
no jax — the full artifact is exercised manually / in release tooling) and
runs it as a bare subprocess with a scrubbed environment, the way a user on
a Python-less host would. Reference capability: the PyInstaller one-file
executables (/root/reference/build.spec:5-65)."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

from build_standalone import build_standalone  # noqa: E402

PROBE = """\
import os, sys
print("AMR_PROBE_OK", sys.version_info[0], sys.version_info[1])
print("PREFIX", sys.prefix)
import json, zlib, struct  # stdlib extension modules resolve in the bundle
print("ZLIB", zlib.crc32(b"amr"))
"""


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dist")

    def hook(stage, sp):
        with open(os.path.join(sp, "amr_probe_cli.py"), "w") as f:
            f.write(PROBE)

    path = build_standalone(
        str(out_dir / "probe.run"),
        deps=(),
        entry="amr_probe_cli",
        include_app=False,
        stage_hook=hook,
        level=1,
    )
    return path


def _run(path, home):
    env = {
        "HOME": str(home),
        "PATH": "/usr/bin:/bin",  # sh/tar/gzip/awk only — no python on PATH
    }
    return subprocess.run(
        [path], capture_output=True, text=True, timeout=300, env=env
    )


def test_standalone_runs_without_host_python(artifact, tmp_path):
    res = _run(artifact, tmp_path)
    assert res.returncode == 0, res.stderr
    assert "AMR_PROBE_OK 3" in res.stdout
    assert f"AMR_PROBE_OK {sys.version_info[0]} {sys.version_info[1]}" in res.stdout
    assert str(zlib_crc()) in res.stdout
    # the interpreter must run from the extracted prefix, not the build host's
    prefix = [l for l in res.stdout.splitlines() if l.startswith("PREFIX ")][0]
    assert "amr-standalone" in prefix


def zlib_crc():
    import zlib

    return zlib.crc32(b"amr")


def test_standalone_reuses_extracted_prefix(artifact, tmp_path):
    first = _run(artifact, tmp_path)
    assert first.returncode == 0, first.stderr
    cache = tmp_path / ".cache" / "amr-standalone"
    entries = sorted(os.listdir(cache))
    second = _run(artifact, tmp_path)
    assert second.returncode == 0, second.stderr
    assert sorted(os.listdir(cache)) == entries  # digest-keyed reuse, no re-extract
    assert "AMR_PROBE_OK" in second.stdout
