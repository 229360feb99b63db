"""The port's multi-device encode (``zigflac_tpu_torch.parallel``) on the
CPU: meshes of the CPU device repeated 2, 4 and 8 times in one process, and
groups of 2 and 4 processes over gloo, against the JAX package's sharded
encode on its virtual 8-device CPU mesh, the port's single device and the
golden oracle. Capacity-ladder re-encodes must stay on their shard.

Tolerance: exact equality of the bytes and the frame sizes."""

import hashlib
import io
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zigflac_tpu
import zigflac_tpu_torch as zt
from conftest import make_signal
from zigflac_tpu.models.pipeline import _collect_aligned as jax_collect_aligned
from zigflac_tpu.parallel import mesh as jax_mesh
from zigflac_tpu.utils.config import EncoderConfig as JaxConfig
from zigflac_tpu_torch.metadata import StreamInfo
from zigflac_tpu_torch.models import pipeline
from zigflac_tpu_torch.ops import deposit
from zigflac_tpu_torch.parallel import distributed as dist
from zigflac_tpu_torch.parallel.mesh import Mesh, default_mesh, encode_compact_sharded
from zigflac_tpu_torch.wav import write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(params=[2, 4, 8], ids=lambda n: f"{n}shards")
def mesh(request):
    return default_mesh([CPU] * request.param)


def _wav(samples) -> bytes:
    buf = io.BytesIO()
    write_wav(buf, samples.astype(np.int32), 44100, 16)
    return buf.getvalue()


def _golden(wav, **cfg):
    return zigflac_tpu.encode_wav_bytes(wav, config=JaxConfig(**cfg), backend="golden")


@pytest.fixture
def shard_by_default(monkeypatch):
    """Sets the mesh that the port's default rule picks for every new
    pipeline (None: a single device), so that the entry points shard."""
    holder = [None]
    monkeypatch.setattr(pipeline, "_product_mesh", lambda device: holder[0])
    return holder


@pytest.fixture
def overflow_calls(monkeypatch):
    """The frame rows of every capacity-ladder re-encode, as (rows, real):
    a host chunk's, or the frames a single device unpacked at the dispatch."""
    calls = []
    real = pipeline.DevicePipeline._encode_overflow

    def spy(self, rec):
        calls.append((rec.get("chunk", rec.get("frames")).shape[0], rec["nreal"]))
        return real(self, rec)

    monkeypatch.setattr(pipeline.DevicePipeline, "_encode_overflow", spy)
    return calls


# -- one process, meshes of the CPU device ----------------------------------------

B16, NF16 = 256, 16  # tests/test_parallel.py's shape on the JAX package's 8 devices


@pytest.fixture(scope="module")
def frames16():
    samples = make_signal(np.random.default_rng(0x5A4D), NF16 * B16, kind="mixed")
    return samples.reshape(2, NF16, B16).transpose(1, 0, 2).copy()


@pytest.fixture(scope="module")
def jax_sharded16(frames16):
    """The JAX package's encode_compact_sharded on its virtual CPU mesh,
    collected shard by shard: (bytes, sizes)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual multi-device CPU mesh")
    m = jax_mesh.default_mesh(jax.devices())
    cfg = JaxConfig(block_size=B16, channels="stereo_auto")
    stream, meta, frame_cap = jax_mesh.encode_compact_sharded(
        jnp.asarray(frames16), jnp.asarray(np.arange(NF16, dtype=np.int64)), cfg, depth=16,
        sample_rate=44100, tier=0, deposit="segsum", mesh=m)
    per = NF16 // m.devices.size
    parts, sizes = [], []
    for s in range(m.devices.size):
        got = jax_collect_aligned((stream[s], meta[s, :-1]), per, frame_cap)
        parts.append(got[0])
        sizes.extend(got[1].tolist())
    return b"".join(parts), sizes


def test_sharded_matches_single(frames16, jax_sharded16, mesh):
    """encode_compact_sharded: every shard's metadata row carries its own
    and the global overflow flag (both 0 here), and its rows collect to the
    JAX package's sharded bytes and the port's single-device bytes."""
    cfg = zt.EncoderConfig(block_size=B16, channels="stereo_auto")
    rows, frame_cap = encode_compact_sharded(
        frames16, np.arange(NF16, dtype=np.int64), cfg, 16, 44100, 0, mesh)
    per = NF16 // mesh.size
    assert sorted(rows) == list(range(mesh.size))
    parts, sizes = [], []
    for s in range(mesh.size):
        stream, meta = rows[s]
        assert meta.shape == (per + 3,) and meta[-2] == 0 and meta[-1] == 0
        got = pipeline._collect_aligned(stream, meta[:-1], per, frame_cap)
        parts.append(got[0])
        sizes.extend(got[1].tolist())
    assert (b"".join(parts), sizes) == jax_sharded16
    single = pipeline.DevicePipeline(cfg, 16, CPU)
    assert single._mesh is None
    stream, want_sizes = single.encode_frames_stream(
        frames16, 0, StreamInfo(44100, 2, 16, NF16 * B16, B16, B16))
    assert b"".join(parts) == stream and sizes == want_sizes.tolist()


def test_sharded_overflow_stays_sharded(mesh, shard_by_default, overflow_calls):
    """Full-scale noise overflows tier 0 on every shard: each re-encodes its
    own rows through the ladder (the batch is never de-sharded), and the
    file equals the golden oracle's."""
    B = 1024
    nf = 2 * mesh.size
    wav = _wav(make_signal(np.random.default_rng(0x0F), nf * B, kind="noise"))
    shard_by_default[0] = mesh
    sharded = zt.encode_wav_bytes(wav, config=zt.EncoderConfig(block_size=B), device="cpu")
    assert sharded == _golden(wav, block_size=B)
    assert len(overflow_calls) == mesh.size
    assert all(rows == nf // mesh.size for rows, _ in overflow_calls), overflow_calls


def test_sharded_ragged_batch_with_partial_overflow(mesh, shard_by_default, overflow_calls):
    """A frame count not divisible by the mesh size (the batch pads to a
    multiple of it) where only one shard holds incompressible rows: that
    shard alone re-encodes, a shard whose real rows are noise and padding
    but fit does not, and the file equals the single device's and the
    golden oracle's."""
    B = 1024
    nf = 2 * mesh.size + 3  # bucket 4 * size: 4 rows a shard, the last ones padding
    per = 4
    tonal = make_signal(np.random.default_rng(0x10), (nf - 2 * per + 1) * B, kind="mixed")
    noise = make_signal(np.random.default_rng(0x11), (2 * per - 1) * B, kind="noise")
    wav = _wav(np.concatenate([tonal, noise], axis=1))
    cfg = zt.EncoderConfig(block_size=B)
    shard_by_default[0] = mesh
    sharded = zt.encode_wav_bytes(wav, config=cfg, device="cpu")
    assert overflow_calls == [(per, per)]  # the one shard of four noise rows
    shard_by_default[0] = None
    assert sharded == zt.encode_wav_bytes(wav, config=cfg, device="cpu")
    assert sharded == _golden(wav, block_size=B)


def test_product_pipeline_shards_lpc(mesh, shard_by_default):
    """LPC mode through the sharded pipeline: coefficients derive on each
    shard from its own rows, and the bytes equal the golden oracle's."""
    B = 512
    wav = _wav(make_signal(np.random.default_rng(0x12), 9 * B, kind="sine"))
    shard_by_default[0] = mesh
    sharded = zt.encode_wav_bytes(
        wav, config=zt.EncoderConfig(block_size=B, prediction="lpc", lpc_order=4), device="cpu")
    assert sharded == _golden(wav, block_size=B, prediction="lpc", lpc_order=4)


def test_one_deposit_per_shard_per_batch(mesh):
    """Every full batch runs one deposit on each shard (here the plain
    version: the shards are on the CPU), and the bytes do not change."""
    B, bs = 256, 2 * mesh.size
    frames = make_signal(np.random.default_rng(0x13), 2 * bs * B, kind="mixed")
    frames = frames.reshape(2, 2 * bs, B).transpose(1, 0, 2).copy()
    info = StreamInfo(44100, 2, 16, 2 * bs * B, B, B)
    cfg = zt.EncoderConfig(block_size=B)
    sharded = pipeline.DevicePipeline(cfg, 16, CPU, batch_size=bs, mesh=mesh)
    deposit.reset_counts()
    got = sharded.encode_frames_stream(frames, 0, info)
    assert (deposit.PLAIN_CALLS, deposit.KERNEL_LAUNCHES) == (2 * mesh.size, 0)
    want = pipeline.DevicePipeline(cfg, 16, CPU, batch_size=bs).encode_frames_stream(
        frames, 0, info)
    assert got[0] == want[0] and got[1].tolist() == want[1].tolist()


def test_distributed_helpers_single_process(mesh):
    """Process-topology helpers degrade exactly in the 1-process case: the
    whole frame range is local, allgather is identity, and
    initialize(num_processes=1) is a no-op."""
    assert dist.initialize(num_processes=1) is False
    assert not dist.is_initialized()
    assert dist.process_count() == 1 and dist.process_index() == 0
    ndev = mesh.size
    assert dist.local_row_bounds(mesh, 4 * ndev) == (0, 4 * ndev)
    with pytest.raises(ValueError):
        dist.local_row_bounds(mesh, 4 * ndev + 1)  # not divisible
    payload, sizes = dist.allgather_parts(b"abc", np.array([1, 2], np.int64))
    assert payload == b"abc" and sizes.tolist() == [1, 2]
    payload, sizes = dist.allgather_parts(b"", np.zeros(0, np.int64))
    assert payload == b"" and sizes.size == 0
    assert not hasattr(dist, "make_global_batch")  # each rank slices its own rows


def test_default_rule_and_mesh_checks(monkeypatch):
    """The default rule: no group and no card means one device, and
    ZIGFLAC_MESH=0 means one device whatever is visible; an explicit mesh
    wins, and default_mesh() without a card raises. A mesh must be
    process-major and divide the batch."""
    assert pipeline._product_mesh(CPU) is None
    cfg = zt.EncoderConfig(block_size=256)
    assert pipeline.DevicePipeline(cfg, 16, CPU)._mesh is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("ZIGFLAC_MESH", "0")
    assert pipeline._product_mesh(torch.device("cuda")) is None
    explicit = default_mesh([CPU, CPU])
    assert pipeline.DevicePipeline(cfg, 16, CPU, mesh=explicit)._mesh is explicit
    assert explicit.entries == ((0, CPU), (0, CPU)) and explicit.devices == (CPU, CPU)
    with pytest.raises(RuntimeError, match="is_available"):
        default_mesh()  # no card here, and no fall to the CPU
    with pytest.raises(ValueError, match="process-major"):
        dist.local_row_bounds(Mesh(((0, CPU), (1, CPU), (0, CPU))), 6)
    with pytest.raises(ValueError, match="no devices"):
        dist.local_row_bounds(Mesh(((1, CPU),)), 2)
    with pytest.raises(ValueError, match="not divisible"):
        encode_compact_sharded(np.zeros((3, 2, 64), np.int32), np.arange(3), cfg, 16, 44100, 0,
                               explicit)
    with pytest.raises(ValueError):
        default_mesh([])


# -- groups of processes over gloo ----------------------------------------------------

# One rank of a gloo group, started as torchrun would start it (MASTER_ADDR,
# MASTER_PORT, WORLD_SIZE and RANK in its environment); argv = the input
# file. It prints one JSON line of what it saw.
CHILD = r"""
import hashlib, json, sys
import numpy as np, torch
import zigflac_tpu_torch as zt
from zigflac_tpu_torch.metadata import StreamInfo
from zigflac_tpu_torch.models import pipeline
from zigflac_tpu_torch.parallel import distributed as dist
from zigflac_tpu_torch.parallel.mesh import default_mesh, encode_compact_sharded

path = sys.argv[1]
assert dist.initialize(backend="gloo") is True
assert dist.initialize(num_processes=1) is True  # idempotent
rank, nproc = dist.process_index(), dist.process_count()
inp = np.load(path)
sha = lambda b: hashlib.sha256(b).hexdigest()
calls = []
real = pipeline.DevicePipeline._encode_overflow
def spy(self, rec):
    calls.append(int(rec["chunk"].shape[0]))
    return real(self, rec)
pipeline.DevicePipeline._encode_overflow = spy
out = {"count": dist.process_count(), "index": dist.process_index()}
cfg = zt.EncoderConfig(block_size=1024)
# the default mesh: every rank with its one device
out["wav_sha"] = sha(zt.encode_wav_bytes(inp["wav"].tobytes(), config=cfg, device="cpu"))
out["wav_mesh"] = len(pipeline.DevicePipeline(cfg, 16, "cpu")._mesh.entries)
out["wav_overflow_calls"], calls[:] = list(calls), []
# two devices a rank: padding-only shards, one rank's rows all padding at 4
frames = inp["frames"]
pipe = pipeline.DevicePipeline(cfg, 16, "cpu", mesh=default_mesh(["cpu", "cpu"]))
stream, sizes = pipe.encode_frames_stream(
    frames, 0, StreamInfo(44100, 2, 16, frames.shape[0] * 1024, 1024, 1024))
out["pipe_sha"], out["pipe_sizes"] = sha(stream), sizes.tolist()
out["pipe_overflow_calls"] = calls
# unequal parts, rank 0's empty
payload, sizes = dist.allgather_parts(bytes([65 + rank]) * (3 * rank),
                                      np.arange(rank, dtype=np.int64))
out["gathered"], out["gathered_sizes"] = payload.decode(), sizes.tolist()
# the any-reduce: only rank 0's rows are noise
m = default_mesh(["cpu"])
rows, _ = encode_compact_sharded(inp["flags"], np.arange(2 * nproc), cfg, 16, 44100, 0, m)
out["flags"] = [int(rows[rank][1][-2]), int(rows[rank][1][-1])]
print("RESULT " + json.dumps(out))
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _group_inputs(nproc: int):
    """The three inputs of a group of ``nproc`` ranks: a WAV of 2n+3 frames
    and a tail, its first four frames noise (rank 0's shard), a ragged
    frame batch for n ranks of two
    devices (frames 2n+1: the last shard padding only, the shard before
    holds one noisy frame and padding, the one before that two noisy
    frames), and 2n frames of which rank 0's two are noise."""
    B = 1024
    nf = 2 * nproc + 3
    x = np.concatenate([make_signal(np.random.default_rng(0x20), 4 * B, kind="noise"),
                        make_signal(np.random.default_rng(0x21), (nf - 4) * B + 500,
                                    kind="mixed")], axis=1)
    n2 = 2 * nproc + 1
    f = np.concatenate([make_signal(np.random.default_rng(0x22), (n2 - 3) * B, kind="mixed"),
                        make_signal(np.random.default_rng(0x23), 3 * B, kind="noise")], axis=1)
    g = np.concatenate([make_signal(np.random.default_rng(0x24), 2 * B, kind="noise"),
                        make_signal(np.random.default_rng(0x25), (2 * nproc - 2) * B,
                                    kind="mixed")], axis=1)
    as_frames = lambda s: s.reshape(2, -1, B).transpose(1, 0, 2).copy()
    return _wav(x), as_frames(f), as_frames(g)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}procs")
def group(request, tmp_path_factory):
    """Runs CHILD in ``n`` processes at once; returns (n, inputs, each
    rank's JSON). Any rank that fails fails the tests."""
    nproc = request.param
    wav, frames, flags = _group_inputs(nproc)
    path = str(tmp_path_factory.mktemp("gloo") / "inputs.npz")
    np.savez(path, wav=np.frombuffer(wav, np.uint8), frames=frames, flags=flags)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(nproc))
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, path], cwd=ROOT,
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-3000:]}"
    results = [json.loads(next(ln for ln in t.splitlines() if ln.startswith("RESULT "))[7:])
               for t in outs]
    return nproc, (wav, frames, flags), results


def test_gloo_group_topology(group):
    nproc, _, results = group
    assert [(r["count"], r["index"]) for r in results] == [(nproc, i) for i in range(nproc)]
    assert all(r["wav_mesh"] == nproc for r in results)


def test_gloo_group_encode_equals_single_process(group):
    """encode_wav_bytes on the default mesh (a rank and its device each),
    and a ragged batch over two devices a rank with padding-only shards,
    give the single process's bytes on every rank; the ladder re-encodes
    only the overflowing shards, each with its own rows, in the rank that
    owns them."""
    nproc, (wav, frames, _), results = group
    cfg = zt.EncoderConfig(block_size=1024)
    want = hashlib.sha256(zt.encode_wav_bytes(wav, config=cfg, device="cpu")).hexdigest()
    assert all(r["wav_sha"] == want for r in results)
    stream, sizes = pipeline.DevicePipeline(cfg, 16, CPU).encode_frames_stream(
        frames, 0, StreamInfo(44100, 2, 16, frames.shape[0] * 1024, 1024, 1024))
    want = hashlib.sha256(stream).hexdigest()
    assert all((r["pipe_sha"], r["pipe_sizes"]) == (want, sizes.tolist()) for r in results)
    # 2n + 1 frames pad to 4n rows, two a shard: shard n - 1, frames 2n - 2
    # and 2n - 1, is the one that overflows
    calls = [r["pipe_overflow_calls"] for r in results]
    owner = (nproc - 1) // 2
    assert calls == [[2] if i == owner else [] for i in range(nproc)], calls
    # 2n + 3 frames pad to 4n rows, four a shard: rank 0's are the noise
    assert [r["wav_overflow_calls"] for r in results] == [[4]] + [[]] * (nproc - 1)


def test_gloo_group_allgather_parts(group):
    """Unequal parts, rank 0's empty, gathered in rank order on every rank."""
    nproc, _, results = group
    want = "".join(chr(65 + r) * (3 * r) for r in range(nproc))
    want_sizes = [s for r in range(nproc) for s in range(r)]
    assert all((r["gathered"], r["gathered_sizes"]) == (want, want_sizes) for r in results)


def test_gloo_group_overflow_any_reduce(group):
    """Only rank 0's rows overflow: its local flag is set, every rank's
    global flag is."""
    nproc, _, results = group
    assert [r["flags"] for r in results] == [[1, 1]] + [[0, 1]] * (nproc - 1)
