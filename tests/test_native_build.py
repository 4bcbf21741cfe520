"""The native loader's first-use build: when it fails, the reason is kept
so the CLI can say why it fell back to the NumPy decoder."""

from navtech_radar_slam_tpu.runtime import loader


def test_failed_build_reports_its_reason(tmp_path, monkeypatch):
    monkeypatch.setattr(loader, "_RUNTIME_DIR", str(tmp_path))  # no Makefile
    monkeypatch.setattr(loader, "_LIB_PATH", str(tmp_path / "lib" / "x.so"))
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_build_error", None)
    assert loader.native_build_error() is None
    assert not loader.native_available()
    reason = loader.native_build_error()
    assert reason.startswith(("make failed:", "make did not run:")), reason
    # the failure is remembered: no second build attempt
    assert not loader.native_available()
    assert loader.native_build_error() == reason
