"""REAL multi-process multihost decode: two jax.distributed processes on
localhost (CPU), each decoding its round-robin shard, manifests all-gathered
over the Gloo control plane. Complements the single-process degeneracy test
in test_batch.py."""

import json
import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent(
    """
    import sys, os, json, time
    sys.path.insert(0, {repo!r})
    pid = int(sys.argv[1]); port = sys.argv[2]; workdir = sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from audio_modem_radio.parallel import multihost
    multihost.initialize(
        coordinator_address=f"localhost:{{port}}", num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2, jax.process_count()
    os.chdir(workdir)
    from audio_modem_radio.assembly import AssemblyRegistry
    from audio_modem_radio.encoder import encode_file
    if pid == 0:
        wavs = []
        for i in range(4):
            data = bytes(f"multi host file {{i}} ".encode() * 25)
            open(f"m{{i}}.bin", "wb").write(data)
            wavs.append(encode_file(f"m{{i}}.bin", mode="QPSK", symbol_rate=4800))
        # Atomic publish: write to a temp name, then rename — the peer polls
        # for existence and must never see a half-written JSON.
        json.dump(wavs, open("wavs.json.tmp", "w"))
        os.rename("wavs.json.tmp", "wavs.json")
    else:
        while not os.path.exists("wavs.json"):
            time.sleep(0.3)
    wavs = json.load(open("wavs.json"))
    saved = multihost.decode_wav_batch_multihost(
        wavs, "QPSK", 4800, registry=AssemblyRegistry(), recv_dir=f"recv{{pid}}"
    )
    assert len(saved) == 4, (pid, saved)
    # Shards are disjoint: each process decoded only its own half locally.
    local = [p for p in saved if p.startswith(f"recv{{pid}}")]
    assert len(local) == 2, (pid, local)
    for p in local:
        blob = open(p, "rb").read()
        assert blob.startswith(b"multi host file "), p
    print(f"proc {{pid}} OK")
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_multihost_decode(tmp_path):
    port = _free_port()
    prog = _CHILD.format(repo=REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", prog, str(i), str(port), str(tmp_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        # 600 s: the distributed init + 2x jit compile fit easily, but a
        # loaded CI host (parallel suites) was observed to push past 300.
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"proc {i} OK" in out
