"""The port's small utilities against ``vbr_tpu``'s: uniform image
dimensions, keyed warnings, profiling (tests/test_utils_misc.py's cases),
``AppConfig`` and ``reference_data_dir``."""

import json
import logging

import numpy as np
import pytest
import torch

from vbr_tpu.utils import config as j_config
from vbr_tpu.utils import imageproc as j_imageproc
from vbr_tpu.utils import warnings_ as j_warnings
from vbr_tpu_torch.utils import config, imageproc, profiling, warnings_


class TestImageProc:
    def test_uniform_dims(self):
        rng = np.random.default_rng(0)
        imgs = [rng.integers(0, 256, s, dtype=np.uint8)
                for s in ((10, 12, 3), (8, 16, 3), (9, 12, 3))]
        out, hw = imageproc.uniform_image_dimensions(imgs)
        want, want_hw = j_imageproc.uniform_image_dimensions(imgs)
        assert hw == want_hw == (8, 12)
        for a, b in zip(out, want):
            np.testing.assert_array_equal(a, b)

    def test_empty(self):
        assert (imageproc.uniform_image_dimensions([])
                == j_imageproc.uniform_image_dimensions([]) == ([], (0, 0)))


class TestWarnings:
    @pytest.mark.parametrize("mid", ["video_none", "preview_failed"])
    def test_known_ids(self, caplog, mid):
        with caplog.at_level(logging.WARNING, logger="vbr_tpu"):
            msg = warnings_.show_warning(mid, "cam2")
        assert msg == j_warnings.show_warning(mid, "cam2")
        assert msg in caplog.text and "(cam2)" in msg

    def test_unknown_id(self):
        msg = warnings_.show_warning("no_such_id")
        assert "unknown" in msg and msg == j_warnings.show_warning(
            "no_such_id")


class TestProfiling:
    def test_stage_timer(self):
        t = profiling.StageTimer()
        with t("a"):
            sum(range(1000))
        with t("a", device="cpu"):
            pass
        with t("b", device=torch.zeros(2)):
            pass
        assert t.counts["a"] == 2 and t.counts["b"] == 1
        assert t.totals["a"] > 0 and t.mean_ms("a") > 0
        assert "a:" in t.report() and "b:" in t.report()

    def test_checked_raises_on_nan(self):
        @profiling.checked
        def f(x):
            return torch.log(x), {"n": x.long()}

        f(torch.ones(3))  # fine; the integer output is not checked
        with pytest.raises(FloatingPointError):
            f(-torch.ones(3))  # log of a negative → nan
        with pytest.raises(FloatingPointError):
            profiling.checked(lambda x: [x / 0.0])(torch.ones(2))  # inf

    def test_device_sync_on_cpu(self):
        profiling.device_sync(torch.ones(2))
        profiling.device_sync((torch.ones(2), {"x": torch.zeros(1)}))

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with profiling.trace(str(tmp_path), name="t") as prof:
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
        doc = json.loads((tmp_path / "t.json").read_text())
        assert doc["traceEvents"]
        assert any("mm" in e.key for e in prof.key_averages())


class TestConfig:
    def test_app_config_load(self, tmp_path):
        p = tmp_path / "config.json"
        p.write_text(json.dumps({"window_width": 800, "far": 250.0,
                                 "debug_mode": True}))
        got = config.AppConfig.load(str(p))
        want = j_config.AppConfig.load(str(p))
        assert got.__dict__ == want.__dict__
        assert got.window_width == 800 and got.world_depth == 128
        assert config.AppConfig().__dict__ == j_config.AppConfig().__dict__

    def test_reference_data_dir(self, tmp_path, monkeypatch):
        monkeypatch.setenv("VBR_DATA_DIR", str(tmp_path))
        assert config.reference_data_dir() == str(tmp_path)
        monkeypatch.setenv("VBR_DATA_DIR", str(tmp_path / "missing"))
        monkeypatch.setattr(config.os.path, "isdir",
                            lambda p: False)
        with pytest.raises(FileNotFoundError):
            config.reference_data_dir()
