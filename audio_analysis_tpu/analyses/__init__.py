"""Reference-parity analysis modules (one per CLI command), built on ops/.

Import the modules themselves (`from audio_analysis_tpu.analyses import
decay`); most of them plot and need matplotlib, so none is imported here.
"""
