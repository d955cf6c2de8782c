"""Whole runs of a cell at a tiny size on the CPU: the result line's
schema, a cell and a metric added as new files, and the faults of the timed
path that the comparison has to catch."""

import numpy as np
import pytest
import torch

from portbench_tiny import CELL, METRIC, run_tiny, tiny_root

E2E = {"barcodes_per_s", "peak_device_gib", "setup_s"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("bench"))


def test_result_line_untraced(root):
    rc, res, err = run_tiny(root)
    assert rc == 0, err
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, err
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == E2E
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == {"rows_gap", "render_lines_off",
                                  "jobs_failed"}
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"]
        assert f"check {name}:" in err
    # the checks are the last lines on standard error
    assert err.strip().splitlines()[-1].startswith("check ")


def test_result_line_traced_takes_the_new_metric(root):
    rc, res, err = run_tiny(root, seed=3, traced=True)
    assert rc == 0, err
    assert res["correct"] is True, err
    got = set(res["metrics"])
    assert METRIC in got  # a reader added as a file of its own
    assert res["metrics"][METRIC]["value"] == res["attempted"]
    assert {"render.ms_per_kbarcode", "engine_setup.ms_per_job",
            "prep_wait.fraction", "dispatch.fraction", "fetch.fraction",
            "wire.bytes_per_barcode"} <= got
    # no CUDA kernel runs on the CPU: the roofline readers find nothing
    # and their metrics are left out, never reported as 0
    assert not {"front_roofline", "pair_roofline", "device_roofline"} & got
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _patch_step(monkeypatch, fault):
    """Break the block step the engine's timed path runs."""
    from demuxlet_tpu_torch.models import decision

    real = decision.compact_step_body_exact

    def broken(*args, **kw):
        rows = real(*args, **kw)
        if fault == "unchanged":
            return torch.zeros_like(rows)
        if fault == "half":
            half = rows.shape[0] // 2
            out = rows.clone()
            out[half:] = rows[:half].mean(dim=0)
            return out
        out = rows.clone()  # one LLK of one cell altered where produced
        out[0, 0] += 0.5
        return out

    monkeypatch.setattr(decision, "compact_step_body_exact", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_step_is_not_correct(root, monkeypatch, fault):
    _patch_step(monkeypatch, fault)
    rc, res, err = run_tiny(root, seed=5)
    assert rc == 0, err
    assert res["correct"] is False
    assert res["checks"]["rows_gap"]["value"] > \
        res["checks"]["rows_gap"]["limit"]


def test_fault_in_a_later_job_is_not_correct(root, monkeypatch):
    """A window keeps one output a library and compares the rest with it:
    a job whose output differs from its library's first is compared with
    the reference too."""
    from demuxlet_tpu_torch.models import decision

    real = decision.compact_step_body_exact
    calls = []

    def late(*args, **kw):
        rows = real(*args, **kw)
        calls.append(1)
        if len(calls) > 12:  # after the warm-up and the first window jobs
            rows = rows.clone()
            rows[0, 0] += 0.5
        return rows

    monkeypatch.setattr(decision, "compact_step_body_exact", late)
    rc, res, err = run_tiny(root, seed=8, seconds=2.0)
    assert rc == 0, err
    assert res["attempted"] > 6, err
    assert res["correct"] is False
    assert res["checks"]["rows_gap"]["value"] > \
        res["checks"]["rows_gap"]["limit"]


def test_altered_answer_in_text_is_not_correct(root, monkeypatch):
    from demuxlet_tpu_torch.models import outputs

    real = outputs.write_pass2_compact

    def altered(stats, sample_ids, compact, grid, prior, s2, sb, **kw):
        real(stats, sample_ids, compact, grid, prior, s2, sb, **kw)
        text = sb.getvalue()
        sb.seek(0)
        sb.truncate()
        sb.write(text.replace("SNG-", "SNG-X", 1))

    monkeypatch.setattr(outputs, "write_pass2_compact", altered)
    rc, res, err = run_tiny(root, seed=6)
    assert rc == 0, err
    assert res["correct"] is False
    assert res["checks"]["render_lines_off"]["value"] >= 1


def test_failed_job_is_not_correct(root, monkeypatch):
    from demuxlet_tpu_torch.models.engine import DemuxEngine

    def fails(self, scl, prior):
        raise RuntimeError("planted")

    monkeypatch.setattr(DemuxEngine, "run_compact", fails)
    # the warm-up raises: no result line at all
    with pytest.raises(RuntimeError):
        run_tiny(root, seed=7)


def test_no_card_no_result(root, monkeypatch, capsys):
    import time

    from portbench import harness

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.run(root, CELL, 9, 0.1, False, time.monotonic())
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_tiny_cell_on_the_card(root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import io
    import json
    import time

    from portbench import harness

    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(root, CELL, 2 ** 31 + 3, 0.5, True, time.monotonic(),
                     out=out, err=err)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True, err.getvalue()
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    for name in ("front_roofline", "pair_roofline", "device_roofline"):
        assert 0 < res["metrics"][name]["value"] <= 100
    assert np.isfinite(res["metrics"]["device.idle_share"]["value"])
