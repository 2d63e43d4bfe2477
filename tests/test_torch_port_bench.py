"""The port's ``bench`` command on the CPU at its smallest sizes: the
headline's one JSON line on standard output (and the ICP-subsampled line),
the five suite metrics, the ``--write`` payload, the launch-count line,
and the flag errors that must stop it before anything is measured, as
``tests/test_bench_smoke.py`` checks them for the JAX benchmark."""

import json

import pytest
import torch

from scream_tpu_torch import bench
from scream_tpu_torch import cli as tcli

SMOKE_ENV = {
    "BENCH_BATCH": "2",
    "BENCH_POINTS": "512",
    "BENCH_ITERS": "2",
    "BENCH_ICP_ITERS": "3",
    "BENCH_RANDOM_PARAMS": "1",
    "BENCH_DTYPE": "float32",
}
# The suite's classes at their smallest sizes (above each class's point
# margins: KITTI subtracts 512, the GAN class 128).
SUITE_ENV = {
    "BENCH_ITERS": "1",
    "BENCH_ICP_ITERS": "2",
    "BENCH_SUITE_ONLY": "kitti,opengf,serve,gan",
    "BENCH_SUITE_KITTI_POINTS": "576",
    "BENCH_SUITE_DEM_POINTS": "128",
    "BENCH_SUITE_SERVE_POINTS": "128",
    "BENCH_SUITE_GAN_POINTS": "192",
    "BENCH_KITTI_ICP_ITERS": "4",
    "BENCH_KITTI_ICP_CHUNK": "2",
}
SUITE_METRICS = {"kitti_registration_pairs_per_sec",
                 "kitti_registration_pairs_per_sec_requeue",
                 "opengf_dem_patches_per_sec", "gt_free_serving_pairs_per_sec",
                 "adversarial_train_pairs_per_sec"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(monkeypatch, capsys, argv, env=()):
    for k, v in {**SMOKE_ENV, **dict(env)}.items():
        monkeypatch.setenv(k, v)
    tcli.main(["bench", "--device", "cpu", *argv])
    return capsys.readouterr()


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


class TestBench:
    def test_headline_lines_and_write(self, monkeypatch, capsys, tmp_path):
        out_path = tmp_path / "bench.json"
        captured = _run(monkeypatch, capsys, ["--write", str(out_path)])
        (rec,) = _json_lines(captured.out)  # one JSON line on stdout
        assert rec["metric"] == "3dmatch_registration_pairs_per_sec_per_chip"
        assert rec["value"] > 0 and rec["unit"] == "pairs/sec" and "vs_baseline" in rec
        (sub,) = _json_lines(captured.err)
        assert sub["metric"] == "3dmatch_registration_pairs_per_sec_icp_subsampled"
        assert sub["value"] > 0
        assert "# params: random init" in captured.err
        med = [ln for ln in captured.err.splitlines() if ln.startswith("# backend=cpu")]
        assert len(med) == 1 and "median_re_deg=" in med[0]
        launches = [ln for ln in captured.err.splitlines() if ln.startswith("# launches ")]
        assert set(json.loads(launches[0][11:])) >= {"attn_stats", "nn_exact", "nn_bounded"}
        payload = json.loads(out_path.read_text())
        assert payload["backend"] == "cpu"
        assert {r["metric"] for r in payload["results"]} == {rec["metric"], sub["metric"]}

    def test_suite_metrics(self, monkeypatch, capsys, tmp_path):
        out_path = tmp_path / "suite.json"
        captured = _run(monkeypatch, capsys, ["--suite", "--write", str(out_path)], SUITE_ENV)
        recs = _json_lines(captured.err)
        assert {r["metric"] for r in recs} == SUITE_METRICS
        assert all(r["value"] > 0 for r in recs)
        assert {r["metric"] for r in json.loads(out_path.read_text())["results"]} == \
            SUITE_METRICS
        assert captured.out == ""  # BENCH_SUITE_ONLY skips the headline

    @pytest.mark.parametrize("argv", [["--suit"], ["--write"], ["--write", "--suite"],
                                      ["--breakdown"], ["--trace", "d"]])
    def test_bad_flags_exit_2_before_measuring(self, monkeypatch, capsys, argv):
        monkeypatch.setattr(bench, "main", lambda *a: pytest.fail("measured"))
        with pytest.raises(SystemExit) as e:
            tcli.main(["bench", *argv])
        assert e.value.code == 2

    @pytest.mark.parametrize("only,argv", [("kitti,typo", ["--suite"]), ("kitti", [])])
    def test_suite_only_errors_exit_2(self, monkeypatch, capsys, only, argv):
        monkeypatch.setenv("BENCH_SUITE_ONLY", only)
        monkeypatch.setattr(bench, "main", lambda *a: pytest.fail("measured"))
        monkeypatch.setattr(bench, "suite", lambda *a: pytest.fail("measured"))
        with pytest.raises(SystemExit) as e:
            tcli.main(["bench", "--device", "cpu", *argv])
        assert e.value.code == 2
        assert "BENCH_SUITE_ONLY" in capsys.readouterr().err

    def test_cuda_default_without_gpu_raises(self, monkeypatch):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        for k, v in SMOKE_ENV.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="cuda"):
            tcli.main(["bench"])
