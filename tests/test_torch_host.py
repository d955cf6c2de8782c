"""The port's own host layers against the JAX package's originals: each
copied file equals its original once the import paths are mapped back;
the fixture BAM and CRAM give identical pileups through both packages'
ingest (Python and native); the renderer and the wire packer give
identical bytes."""

import ast
import dataclasses
import io
import os
import random
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "demuxlet_tpu_torch"

# (port file, original): the port's copies of the JAX-free host modules
COPIES = [(f"{PORT}/{p}", f"demuxlet_tpu/{p}") for p in (
    "io/__init__.py", "io/bgzf.py", "io/bam.py", "io/cram.py", "io/rans.py",
    "io/vcf.py", "io/bcf.py",
    "host/__init__.py", "host/pileup.py", "host/csr.py", "host/slots.py",
    "host/wire.py", "host/genotypes.py",
    "native/__init__.py", "native/build.py", "native/ingest.py",
    "native/ingest.cpp", "native/cram_reader.inc", "native/prep.py",
    "native/prep.cpp", "native/render.py", "native/render.cpp",
    "utils/logging_utils.py", "utils/phred.py", "utils/intervals.py",
    "models/outputs.py", "ops/luts.py",
)] + [(f"{PORT}/oracle.py", "oracle/numpy_oracle.py")]

# the CLI helpers the port keeps in cli_common.py, from demuxlet_tpu/cli.py
CLI_HELPERS = ["_BgzfText", "_open_out", "build_parser", "_run_parity",
               "_ingest", "_echo_params"]


def _read(rel):
    with open(os.path.join(REPO, rel)) as fh:
        return fh.read()


def _mapped_back(text):
    """The port's import paths mapped onto the JAX package's."""
    text = text.replace(f"from {PORT} import oracle as O",
                        "from oracle import numpy_oracle as O")
    return re.sub(rf"\b{PORT}\b", "demuxlet_tpu", text)


@pytest.mark.parametrize("port,orig", COPIES, ids=[c[0] for c in COPIES])
def test_copy_equals_original(port, orig):
    text = _read(port)
    assert "demuxlet_tpu." not in re.sub(rf"\b{PORT}\b", "", text)
    assert _mapped_back(text) == _read(orig)


def _defs(rel):
    tree = ast.parse(_read(rel))
    text = _read(rel)
    return {n.name: ast.get_source_segment(text, n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("name", CLI_HELPERS)
def test_cli_helper_equals_original(name):
    port, orig = _defs(f"{PORT}/cli_common.py"), _defs("demuxlet_tpu/cli.py")
    assert _mapped_back(port[name]) == orig[name]


def test_cli_common_holds_only_the_helpers():
    assert sorted(_defs(f"{PORT}/cli_common.py")) == sorted(CLI_HELPERS)


# ---------------------------------------------------------------- ingest

def _equal_fields(a, b):
    va, vb = vars(a), vars(b)
    assert sorted(va) == sorted(vb)
    for k in va:
        x, y = va[k], vb[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=k)
        elif isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            assert len(x) == len(y), k
            for p, q in zip(x, y):
                np.testing.assert_array_equal(p, q, err_msg=k)
        else:
            assert x == y, k


@pytest.mark.parametrize("fmt", ["bam", "cram"])
@pytest.mark.parametrize("ingest", ["python", "native"])
def test_pileup_equals_jax_package(tmp_path, fmt, ingest):
    """The fixture BAM, and the same reads as a rANS CRAM, through the
    port's VCF reader and ingest and through the JAX package's: identical
    SNP tables, pileups and counters."""
    from test_cram import _workload

    from demuxlet_tpu.io import vcf as jvcf
    from demuxlet_tpu_torch.io import vcf as tvcf

    vcf, bam, cram = _workload(tmp_path, seed=41, method=4)
    path = bam if fmt == "bam" else cram
    tabs = [m.load_snp_table(vcf, field_name="GT") for m in (tvcf, jvcf)]
    _equal_fields(*tabs)
    if ingest == "native":
        from demuxlet_tpu.native import ingest as jni
        from demuxlet_tpu_torch.native import ingest as tni

        if not (tni.available() and jni.available()):
            pytest.skip("native ingest not built")
        (p_t, c_t), (p_j, c_j) = (m.build_pileup(path, tab)
                                  for m, tab in zip((tni, jni), tabs))
    else:
        from demuxlet_tpu.host import pileup as jp
        from demuxlet_tpu.io import bam as jbam
        from demuxlet_tpu.io import cram as jcram
        from demuxlet_tpu_torch.host import pileup as tp
        from demuxlet_tpu_torch.io import bam as tbam
        from demuxlet_tpu_torch.io import cram as tcram

        rdr = ((lambda m: m.AlignmentReader(path)) if fmt == "bam"
               else (lambda m: m.CramReader(path)))
        p_t, c_t = tp.build_pileup(rdr(tbam if fmt == "bam" else tcram),
                                   tabs[0])
        p_j, c_j = jp.build_pileup(rdr(jbam if fmt == "bam" else jcram),
                                   tabs[1])
    assert type(p_t).__module__.startswith(PORT)
    assert p_t.nbcs > 0
    _equal_fields(p_t, p_j)
    _equal_fields(c_t, c_j)


# ---------------------------------------------------------------- render

@pytest.mark.parametrize("renderer", ["python", "native"])
def test_renderer_bytes_equal_jax_package(monkeypatch, renderer):
    """write_single and write_pass2_compact of the port's outputs module
    against the JAX package's, both on the native or both on the Python
    renderer: identical bytes."""
    from demuxlet_tpu.models import outputs as jout
    from demuxlet_tpu.native import render as jren
    from demuxlet_tpu_torch.models import outputs as tout
    from demuxlet_tpu_torch.models.engine import DemuxEngine, cell_stats
    from demuxlet_tpu_torch.native import render as tren
    from test_torch_engine import _pcr_hot_csr

    if renderer == "python":
        monkeypatch.setattr(jren, "available", lambda: False)
        monkeypatch.setattr(tren, "available", lambda: False)
    elif not (jren.available() and tren.available()):
        pytest.skip("native renderer not built")
    csr, gps = _pcr_hot_csr(8, n_cells=30)
    grid = [0.0, 0.5]
    llks, llk0s, comp = DemuxEngine(gps, grid, cell_block=16,
                                    device=torch.device("cpu")).run_compact(
        csr, 0.5)
    stats = cell_stats(csr)
    jstats = jout.CellStats(**dataclasses.asdict(stats))
    outs = []
    for mod, st in ((tout, stats), (jout, jstats)):
        single, s2, best = io.StringIO(), io.StringIO(), io.StringIO()
        mod.write_single(single, st, csr.sample_ids, llks, llk0s)
        mod.write_pass2_compact(st, csr.sample_ids, comp, grid, 0.5, s2, best)
        outs.append((single.getvalue(), s2.getvalue(), best.getvalue()))
    assert len(outs[0][2].splitlines()) == 31
    assert outs[0] == outs[1]


@pytest.mark.parametrize("packer", ["python", "native"])
def test_wire_packer_bytes_equal_jax_package(packer):
    """The wire-v2 block packer of the port (host/wire.py or native
    prep) against the JAX package's on the same blocks: identical buffers
    and metas, and identical wire configs."""
    from demuxlet_tpu.host import csr as jcsr
    from demuxlet_tpu.host import wire as jw
    from demuxlet_tpu.native import prep as jprep
    from demuxlet_tpu_torch.host import csr as tcsr
    from demuxlet_tpu_torch.host import wire as tw
    from demuxlet_tpu_torch.native import prep as tprep
    from test_torch_engine import _pcr_hot_csr

    csr, _ = _pcr_hot_csr(9, n_cells=40)
    cfg_t, cfg_j = tw.choose_cfg(csr, 40), jw.choose_cfg(csr, 40)
    assert dataclasses.astuple(cfg_t) == dataclasses.astuple(cfg_j)
    if packer == "native" and not (tprep.available() and jprep.available()):
        pytest.skip("native prep not built")
    for cells in (list(range(16)), list(range(16, 40))):
        if packer == "native":
            got = tprep.pack_block_v2(csr, cells, cfg_t, cap_bq=40)
            want = jprep.pack_block_v2(csr, cells, cfg_j, cap_bq=40)
        else:
            got = tw.pack_wire_block(*tcsr.build_codes_block(csr, cells, 40),
                                     cfg_t)
            want = jw.pack_wire_block(*jcsr.build_codes_block(csr, cells, 40),
                                      cfg_j)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])


def test_oracle_copy_matches_original_outputs():
    """The port's oracle copy and oracle/numpy_oracle.py give identical
    .single/.sing2/.best lines on one dict pileup."""
    from demuxlet_tpu_torch import oracle as TO
    from oracle import numpy_oracle as JO

    g = np.random.RandomState(2).dirichlet([2, 2, 2], size=(30, 4))
    lines = []
    for mod in (TO, JO):
        scl = mod.PileupData([f"S{i}" for i in range(4)],
                             [g[i] for i in range(30)])
        r = random.Random(2)
        for c in range(6):
            scl.add_cell(f"BC{c:03d}")
            for _ in range(40):
                scl.cell_totl[c] += 1
                scl.add_read(r.randrange(30), c, f"U{r.randrange(1000)}",
                             r.choice([0, 1, 2]), r.randrange(13, 41))
        gp0s = mod.compute_gp0s(scl)
        llks, llk0s = mod.pass1_singlet(scl, gp0s)
        single = mod.write_single(scl, llks, llk0s)
        sing2, _, best = mod.pass2_outputs(scl, gp0s, [0.0, 0.5])
        lines.append((single, sing2, best))
    assert len(lines[0][2]) == 7
    assert lines[0] == lines[1]
