"""Report suite + bundle runner.

Names resolve lazily, so the engine runners (engine_report, watch) import
without matplotlib; the plot-based ones (report, bundle) need it.
"""

import importlib as _importlib

_EXPORTS = {
    "ReportResults": "report",
    "ReportSettings": "report",
    "run_report_from_wav_file": "report",
    "BundleRunSettings": "bundle",
    "run_bundle_report": "bundle",
    "EngineBundleSettings": "engine_report",
    "run_bundle_report_engine": "engine_report",
    "WatchSettings": "watch",
    "watch_bundle_runs": "watch",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(_importlib.import_module(f"{__name__}.{module}"), name)
