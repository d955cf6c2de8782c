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

# (port file, original): the port's copies of the JAX-free host modules.
# native/render.cpp is not one: the port's renderer is its own design (fields
# by std::to_chars, rows in stripes on threads), held to the same bytes by
# test_renderer_bytes_equal_jax_package below and tests/test_torch_render.py.
COPIES = [(f"{PORT}/{p}", f"demuxlet_tpu/{p}") for p in (
    "io/__init__.py", "io/bgzf.py", "io/bam.py", "io/cram.py", "io/rans.py",
    "io/vcf.py", "io/bcf.py",
    "host/__init__.py", "host/pileup.py", "host/csr.py", "host/slots.py",
    "host/wire.py", "host/genotypes.py",
    "native/__init__.py", "native/build.py", "native/ingest.py",
    "native/ingest.cpp", "native/cram_reader.inc", "native/prep.py",
    "native/prep.cpp", "native/render.py",
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


# The port's render spans (utils/spans): the copies below carry span
# decorators and ``with span(...)`` blocks, which ``_without_spans`` takes
# out, and the native renderer gathers its C arguments into ``args`` (its
# span render.pack) before the call (render.native), and writes the C
# output with ``native/emit.emit`` (decoded straight from the C buffer,
# with no bytes copy of the whole output first). Both renders take the
# barcode order and packed barcodes from ``native/order.barcodes``, which
# builds them once for a CellStats (a native sort keyed by the barcode
# bytes, one join), where the original sorts and encodes them in Python
# at each render: the lines that differ once the spans are out, (the
# port's, the original's).
BARCODES = (["    order, bc_concat, bc_off = barcodes(stats, lib)"],
            ["    order = np.asarray([i for _, i in stats.bc_order()], "
             "np.int64)",
             "    bc_concat, bc_off = _concat(stats.barcodes)"])
SPAN_DIFFS = {
    f"{PORT}/native/render.py": [
        (["from demuxlet_tpu.native.emit import emit",
          "from demuxlet_tpu.native.order import barcodes"], []),
        BARCODES,
        (["    args = ("], ["    rc = lib.dmx_render_pass2_compact("]),
        (["    rc = lib.dmx_render_pass2_compact(*args)"], []),
        (["        emit(wsing2, out2, len2.value)",
          "        emit(wbest, outb, lenb.value)"],
         ["        wsing2.write(C.string_at(out2, len2.value).decode())",
          "        wbest.write(C.string_at(outb, lenb.value).decode())"]),
        BARCODES,
        (["    args = ("], ["    rc = lib.dmx_render_single("]),
        (["    rc = lib.dmx_render_single(*args)"], []),
        (["        emit(fh, out, ln.value)"],
         ["        fh.write(C.string_at(out, ln.value).decode())"]),
    ],
    f"{PORT}/models/outputs.py": [],
}
SPAN_IMPORT = f"from {PORT}.utils.spans import span\n\n"

# The port's own code in three copies, for the engine set-up's native pass
# over all observations (native/obs.py, its C in native/obs.cpp) and the
# block packer (native/pack.py and native/pack.cpp, built into _prep.so): the
# definitions the originals lack, which ``_without_defs`` takes out by name,
# and the lines that differ once they are out, (the port's, the original's).
OWN_CODE = {
    f"{PORT}/host/csr.py": (("obs_pass", "code_hist"), []),
    f"{PORT}/host/wire.py": ((), [
        (["    actual block data. Where the pileup's native pass ran",
          "    (CsrPileup.obs_pass), its cached histogram stands for the "
          "bincount pass."],
         ["    actual block data."]),
        (["    hist = csr.code_hist(cap_bq) if hasattr(csr, \"code_hist\") "
          "else None",
          "    if hist is not None:  # every code counted: no observation "
          "left to pass",
          "        counts, n = hist, 0"], []),
    ]),
    f"{PORT}/native/prep.py": ((), [
        (["OBS_SRC = os.path.join(HERE, \"obs.cpp\")",
          "PACK_SRC = os.path.join(HERE, \"pack.cpp\")"], []),
        (["    # future .inc here. obs.cpp (the set-up's pass over all "
          "observations,",
          "    # native/obs.py) and pack.cpp (the engine's block packer,",
          "    # native/pack.py) are the library's other TUs.",
          "    deps = [SRC, OBS_SRC, PACK_SRC]"],
         ["    # future .inc here.", "    deps = [SRC]"]),
        (["         \"-pthread\", \"-o\", tmp, SRC, OBS_SRC, PACK_SRC],"],
         ["         \"-o\", tmp, SRC],"]),
    ]),
}


def _without_spans(text):
    """``text`` with the span import, each ``@span(...)`` line and each
    ``with span(...):`` line taken out, the body of such a block moved
    back by its indent."""
    out, blocks = [], []  # blocks: the indents of the open span blocks
    for line in text.replace(SPAN_IMPORT, "").split("\n"):
        ind = len(line) - len(line.lstrip())
        while blocks and line.strip() and ind <= blocks[-1]:
            blocks.pop()
        if re.fullmatch(r"\s*@span\(\"[\w.]+\"\)", line):
            continue
        if re.fullmatch(r"\s*with span\(.*\):", line):
            blocks.append(ind)
            continue
        out.append(line[4 * len(blocks):] if line.strip() else line)
    return "\n".join(out)


def _without_defs(text, names):
    """``text`` without the function definitions called ``names``, each
    with the blank lines after it."""
    lines = text.split("\n")
    drop = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.FunctionDef) and node.name in names:
            end = node.end_lineno
            while end < len(lines) and not lines[end].strip():
                end += 1
            start = min([node.lineno] + [d.lineno
                                         for d in node.decorator_list])
            drop.update(range(start - 1, end))
    return "\n".join(ln for i, ln in enumerate(lines) if i not in drop)


@pytest.mark.parametrize("port,orig", COPIES, ids=[c[0] for c in COPIES])
def test_copy_equals_original(port, orig):
    """Each copy equals its original once the import paths are mapped
    back; the two render files once their spans are out, but for the
    lines of SPAN_DIFFS; the three with the port's own code once its
    definitions are out, but for the lines of OWN_CODE."""
    import difflib

    text = _read(port)
    assert "demuxlet_tpu." not in re.sub(rf"\b{PORT}\b", "", text)
    if port in OWN_CODE:
        names, want = OWN_CODE[port]
        assert all(re.search(rf"\n\s*def {n}\(", text) for n in names)
        text = _without_defs(text, names)
    elif port in SPAN_DIFFS:
        assert SPAN_IMPORT in text
        text, want = _without_spans(text), SPAN_DIFFS[port]
    else:
        assert _mapped_back(text) == _read(orig)
        return
    ours = _mapped_back(text).split("\n")
    theirs = _read(orig).split("\n")
    diffs = [(ours[i1:i2], theirs[j1:j2]) for op, i1, i2, j1, j2 in
             difflib.SequenceMatcher(None, ours, theirs,
                                     autojunk=False).get_opcodes()
             if op != "equal"]
    assert diffs == want


def _defs(rel):
    tree = ast.parse(_read(rel))
    text = _read(rel)
    return {n.name: ast.get_source_segment(text, n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


# The lines of build_parser that differ from the original, (the port's,
# the original's), stripped: help strings that describe the port where the
# original's describe the JAX package. Options, choices and defaults are
# the original's.
PARSER_HELP = [
    # the program and what it runs on
    (['prog="demuxlet-torch",'], ['prog="demuxlet-tpu",']),
    (['"Droplet demultiplexing on a CUDA card (PyTorch): deconvolute "',
      '"sample identity and detect doublets from pooled single-cell "',
      '"data using natural genetic variation."'],
     ['"TPU-native droplet demultiplexing: deconvolute sample identity "',
      '"and detect doublets from pooled single-cell data using natural "',
      '"genetic variation."']),
    (['"process handles stripe --shard-id. The built-in analog of "'],
     ['"process handles stripe --shard-id. The TPU-native analog of "']),
    # --dist-coordinator: the port's process group is gloo's
    (['"torch.distributed (gloo) rendezvous address; with --num-shards "',
      '"N and --shard-id k this process joins an N-process run (process "',
      '"k), "'],
     ['"jax.distributed coordinator address; with --num-shards N and "',
      '"--shard-id k this process joins an N-process run (process k), "']),
    (['g = p.add_argument_group("Engine options (CUDA)")'],
     ['g = p.add_argument_group("TPU engine options")']),
    # --device: auto is the CUDA card or an error, tpu is refused
    (['help=(',
      '"Execution platform: auto = the current CUDA card (an error "',
      '"when there is none), cpu = the kernels\' plain PyTorch "',
      '"versions; tpu is refused"', '),'],
     ['help="Execution platform (auto = default JAX backend)",']),
    # --mode fast: the CUDA kernels
    (['"resolve to the mirrored order). fast: f32 CUDA pair-search "',
      '"kernels (calls identical, LLKs approximate "'],
     ['"resolve to the mirrored order). fast: f32 Pallas pair-search "',
      '"kernel (TPU production mode; calls identical, LLKs approximate "']),
    # --exact-kernel: the f64 CUDA kernels or the dense route
    (['"Exact-mode kernel: pallas (and auto) = the f64 CUDA kernels "',
      '"(front and pair search), xla = the dense f64 route in plain "',
      '"PyTorch"'],
     ['"Exact-mode kernel: pallas = df32 (double-single f32) Pallas "',
      '"pair kernel (TPU; ~1e-10 of f64), xla = f64 XLA kernels; "',
      '"auto picks pallas on TPU"']),
    # --cell-block: no claim measured on a TPU
    (['help="Cells per device batch")'],
     ['help="Cells per device batch (2048 peaks both Pallas "',
      '"kernels\' throughput on v5e; 4096 regresses)")']),
    # --profile: a torch.profiler trace
    (['help=(', '"Write a torch.profiler trace of the device passes, the "',
      '"per-cell statistics and the output writes, every thread\'s "',
      '"spans included, to DIR/torch_trace.json"', '),'],
     ['help="Write a JAX profiler trace of the device passes to DIR",']),
]


@pytest.mark.parametrize("name", CLI_HELPERS)
def test_cli_helper_equals_original(name):
    """Each helper equals the original once the import paths are mapped
    back; build_parser differs in the lines of PARSER_HELP and no other."""
    import difflib

    port, orig = _defs(f"{PORT}/cli_common.py"), _defs("demuxlet_tpu/cli.py")
    if name != "build_parser":
        assert _mapped_back(port[name]) == orig[name]
        return
    ours = [l.strip() for l in _mapped_back(port[name]).splitlines()]
    theirs = [l.strip() for l in orig[name].splitlines()]
    diffs = [(ours[i1:i2], theirs[j1:j2]) for op, i1, i2, j1, j2 in
             difflib.SequenceMatcher(None, ours, theirs,
                                     autojunk=False).get_opcodes()
             if op != "equal"]
    assert diffs == PARSER_HELP


def test_port_help_names_neither_jax_nor_tpu():
    """The port's --help describes the port: it names no JAX, TPU, Pallas
    or v5e, and tpu only as the --device choice it refuses."""
    from demuxlet_tpu_torch.cli_common import build_parser

    text = build_parser().format_help()
    assert not re.findall(r"JAX|jax|TPU|Pallas|v5e", text)
    assert "CUDA" in text and "torch.profiler" in text and "gloo" in text
    rest = re.sub(r"\{auto,tpu,cpu\}|tpu is refused|output", "", text,
                  flags=re.IGNORECASE)
    assert "tpu" not in rest.lower()


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
