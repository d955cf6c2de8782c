"""The genome-shard merge's reduce-scatter on the card
(``demuxlet_tpu_torch/parallel/multihost.py``): two processes, each
driving a card of its own as NCCL sees it, merge seeded genome shards
through ``gather_results_sum_compact`` over NCCL, and two processes on one
card over gloo; process 0's merge equals, bit for bit, the one-process
merge of the same shards (``merge_shards_sum``, then the decision pass on
the card over the same stripes): a sum of two terms commutes.

Each process gets its own card with ``CUDA_VISIBLE_DEVICES`` where the
machine has two; on one card, a distinct ``NCCL_HOSTID`` a process (and
``NCCL_SOCKET_IFNAME=lo``) shows NCCL two hosts' cards, as
``chip_smoke.py`` phase 20 runs it. Every test here needs a CUDA card and
skips without one; they import neither JAX nor the JAX package, so they
run with ``python -m pytest --noconftest -m cuda tests/test_torch_nccl.py``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from demuxlet_tpu_torch.models import decision as TD
from demuxlet_tpu_torch.parallel import multihost as tmh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = [0.0, 0.25, 0.5]

_WORKER = """
import dataclasses
import json
import sys
import numpy as np
import torch
from demuxlet_tpu_torch.parallel import multihost as mh
rank, port, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
mh.initialize(f"127.0.0.1:{port}", 2, rank, device=dev)
route = mh.current_route()
z = np.load(src.format(rank))
local = mh.ShardResult(barcodes=[str(b) for b in z["barcodes"]],
                       **{f: z[f] for f in z.files if f != "barcodes"})
got = mh.gather_results_sum_compact(local, %r, 0.5, dev)
mh.shutdown()
print(json.dumps(dict(rank=rank, route=route, uuid=str(
    torch.cuda.get_device_properties(dev).uuid))))
if rank == 0:
    c = got.compact
    np.savez(dst, barcodes=np.asarray(got.barcodes),
             **{f: getattr(got, f) for f in
                ("totl", "pass_", "uniq", "nsnp", "llks", "llk0s")},
             **{"c_" + f.name: getattr(c, f.name)
                for f in dataclasses.fields(c)})
else:
    assert got is None
"""


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (NCCL runs on cards)")
    return torch.device("cuda", 0)


def _own_card_envs():
    """Per process, the environment that gives it a card of its own as
    NCCL sees it: its own card where there are two, else a distinct
    NCCL_HOSTID on the one card, reached over sockets on loopback."""
    if torch.cuda.device_count() >= 2:
        return [dict(CUDA_VISIBLE_DEVICES=str(k)) for k in range(2)]
    return [dict(NCCL_HOSTID=f"test-nccl-{k}", NCCL_SOCKET_IFNAME="lo",
                 CUDA_VISIBLE_DEVICES="0") for k in range(2)]


def _shards(seed, V, A, n_cells):
    """Two seeded genome shards sharing most barcodes."""
    rng = np.random.default_rng(seed)
    names = ["BC%06d" % i for i in rng.permutation(n_cells)]
    out = []
    for _ in range(2):
        bcs = [b for b in names if rng.random() < 0.8]
        n = len(bcs)
        out.append(tmh.ShardResult(
            barcodes=bcs, totl=rng.integers(0, 90, n),
            pass_=rng.integers(0, 90, n), uniq=rng.integers(0, 90, n),
            nsnp=rng.integers(0, 40, n), llks=rng.normal(-40, 9, (n, V)),
            llk0s=rng.normal(-40, 9, n),
            llk_ab=rng.normal(-40, 9, (n, V, V, A)),
            llk_00=rng.normal(-40, 9, (n, A))))
    return out


def _merge_two(tmp_path, shards, envs):
    """Both shards through gather_results_sum_compact in two processes
    with the environments envs: (process 0's CompactShard, each process's
    route and card UUID)."""
    for k, t in enumerate(shards):
        np.savez(tmp_path / f"shard{k}.npz", barcodes=np.asarray(t.barcodes),
                 **{f.name: getattr(t, f.name)
                    for f in dataclasses.fields(t) if f.name != "barcodes"})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dst = str(tmp_path / "merged.npz")
    base = {k: v for k, v in os.environ.items()
            if k not in ("NCCL_HOSTID", "NCCL_SOCKET_IFNAME",
                         "CUDA_VISIBLE_DEVICES")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER % (GRID,), str(k), str(port),
         str(tmp_path / "shard{}.npz"), dst],
        cwd=REPO, env=dict(base, **env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k, env in enumerate(envs)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    seen = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    z = np.load(dst)
    got = tmh.CompactShard(
        barcodes=[str(b) for b in z["barcodes"]],
        **{f: z[f] for f in ("totl", "pass_", "uniq", "nsnp", "llks",
                             "llk0s")},
        compact=TD.CompactResult(
            **{f[2:]: z[f] for f in z.files if f.startswith("c_")}))
    return got, seen


def _one_process(shards, dev):
    """The one-process merge of both shards: merge_shards_sum, then the
    decision pass on dev over the stripes a two-process merge decides
    (stripe_rows rows each, the last chunk padded with zero rows)."""
    m = tmh.merge_shards_sum(shards)
    n, V, _, A = m.llk_ab.shape
    rows = tmh.stripe_rows(2, V * V * A + A + V + 1)
    pad = lambda x: torch.from_numpy(np.concatenate(
        [x, np.zeros((-n % (2 * rows),) + x.shape[1:], x.dtype)])).to(dev)
    ab, a00, llks, llk0s = (pad(x) for x in
                            (m.llk_ab, m.llk_00, m.llks, m.llk0s))
    dbl_w = torch.as_tensor(TD.doublet_weights(V, GRID, 0.5), device=dev)
    dbl_msk = torch.as_tensor(TD.doublet_mask(V, A), device=dev)
    packed = []
    for i in range(0, len(ab), rows):
        sl = slice(i, i + rows)
        out = TD.decide(ab[sl], a00[sl], dbl_w, dbl_msk, 0.5)
        packed.append(TD.pack_rows(out, llks[sl], llk0s[sl]).cpu().numpy())
    llks, llk0s, d = TD.unpack_block(np.concatenate(packed)[:n], V, A)
    return tmh.CompactShard(
        barcodes=m.barcodes, totl=m.totl, pass_=m.pass_, uniq=m.uniq,
        nsnp=m.nsnp, llks=llks, llk0s=llk0s, compact=TD.concat([d]))


def _assert_same(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "compact":
            _assert_same(g, w)
        elif isinstance(w, list):
            assert g == w, f.name
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f.name)


@pytest.mark.cuda
@pytest.mark.parametrize("V,A,n_cells", [(3, 3, 20000), (32, 3, 6000)])
def test_two_processes_reduce_over_nccl(tmp_path, cuda_device, V, A,
                                        n_cells):
    """Two processes with a card each (as NCCL sees it) take the "nccl"
    route, and process 0's merge equals the one-process merge on the card
    bit for bit, over several chunks of the reduce-scatter."""
    shards = _shards(11, V, A, n_cells)
    rows = tmh.stripe_rows(2, V * V * A + A + V + 1)
    assert len(set(shards[0].barcodes) | set(shards[1].barcodes)) > 4 * rows
    got, seen = _merge_two(tmp_path, shards, _own_card_envs())
    assert [s["route"] for s in seen] == ["nccl", "nccl"], seen
    _assert_same(got, _one_process(shards, cuda_device))


@pytest.mark.cuda
def test_two_processes_on_one_card_reduce_on_the_host(tmp_path, cuda_device):
    """Two processes on the same card, with no NCCL_HOSTID, have equal
    merge keys, so both take the "host" route (gloo on host tensors; NCCL
    would refuse two ranks on one device), and process 0's merge equals
    the one-process merge on the card bit for bit."""
    shards = _shards(12, 3, 3, 20000)
    got, seen = _merge_two(tmp_path, shards,
                           [dict(CUDA_VISIBLE_DEVICES="0")] * 2)
    assert [s["route"] for s in seen] == ["host", "host"], seen
    assert seen[0]["uuid"] == seen[1]["uuid"]
    _assert_same(got, _one_process(shards, cuda_device))
