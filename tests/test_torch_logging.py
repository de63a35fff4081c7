"""The port's loggers vs the JAX package's (CPU): the CSV file byte for
byte for the same metric sequence and clock, the process-0 filter, and the
optional backends, which raise where their package is absent."""
import logging
import sys
import time

import pytest

from gif_synthesis_with_discrete_diffusion_tpu.utils import logging as jlog
from gif_synthesis_with_discrete_diffusion_tpu_torch.utils import logging as plog

SEQUENCES = {
    "one key": [({"loss": 1.0}, 0), ({"loss": 0.5}, 1), ({"loss": 0.25}, 2)],
    "keys grow": [({"loss": 1.0}, 0), ({"loss": 0.5, "fvd": 123.0}, 1),
                  ({"loss": 0.4, "fvd": 100.0}, 2),
                  ({"total/val": 3.0, "epoch": 0.0}, 2),
                  ({"loss": 1e-9, "Metrics/fvd-val": float("inf")}, 7)],
    "epoch rows": [({"l/dummy/train": 52.25, "total/train": 52.25,
                     "epoch": 0.0}, 2),
                   ({"l/dummy/val": 41.125, "total/val": 41.125,
                     "epoch": 0.0}, 2),
                   ({"total/step": 12.0009765625}, 3),
                   ({"l/dummy/train": float("nan"), "epoch": 1.0}, 4)],
}


def _write(module, tmp_path, seq, monkeypatch):
    clock = iter(1_700_000_000.0 + 0.125 * i for i in range(100))
    monkeypatch.setattr(time, "time", lambda: next(clock))
    lg = module.CsvLogger(tmp_path)
    for metrics, step in seq:
        lg.log_metrics(metrics, step)
    lg.finalize()
    return lg.path.read_bytes()


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_csv_file_is_byte_equal_to_jax(tmp_path, monkeypatch, name):
    want = _write(jlog, tmp_path / "jax", SEQUENCES[name], monkeypatch)
    got = _write(plog, tmp_path / "port", SEQUENCES[name], monkeypatch)
    assert got == want


def test_logger_emits_on_process_0_only(monkeypatch, caplog):
    log = plog.get_logger("gsdd_port_test")
    with caplog.at_level(logging.INFO, logger="gsdd_port_test"):
        log.info("from rank 0")
        monkeypatch.setattr(plog, "_is_main_process", lambda: False)
        log.info("from rank 1")
    assert [r.message for r in caplog.records] == ["from rank 0"]
    assert plog.get_logger("gsdd_port_test") is log
    assert sum(isinstance(f, plog._Process0Filter) for f in log.filters) == 1


@pytest.mark.parametrize("backend,module", [
    ("wandb", "wandb"), ("mlflow", "mlflow"), ("neptune", "neptune"),
    ("comet", "comet_ml"), ("tensorboard", "tensorboard")])
def test_an_absent_backend_raises_naming_its_package(tmp_path, monkeypatch,
                                                     backend, module):
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(ImportError, match=module):
        plog.build_metric_loggers({"csv": {}, backend: {}}, tmp_path)


def test_tensorboard_writes_events_where_installed(tmp_path):
    pytest.importorskip("tensorboard")
    (lg,) = plog.build_metric_loggers({"tensorboard": {}}, tmp_path)
    lg.log_metrics({"total/val": 1.0}, step=1)
    lg.finalize()
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))


def test_build_metric_loggers_follows_jax(tmp_path):
    cfg = {"csv": {}, "csv_disabled": {}, "unknown": {}}
    got = plog.build_metric_loggers(cfg, tmp_path)
    want = jlog.build_metric_loggers(cfg, tmp_path)
    assert [type(lg).__name__ for lg in got] == \
        [type(lg).__name__ for lg in want] == ["CsvLogger"]
    assert plog.build_metric_loggers({"csv": {"enabled": False}},
                                     tmp_path) == []
    assert set(plog._BACKENDS) == set(jlog._BACKENDS)
