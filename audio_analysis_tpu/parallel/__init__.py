"""
Parallelism layer.

- parallel.overlap — host/device overlap: the plot-worker thread the report
  suite uses to render figures concurrently with device compute.
- Device/host scale-out re-exports (the machinery lives with the engine it
  parallelises):
  - audio_analysis_tpu.engine.mesh        — single-host mesh, shard_map
  - audio_analysis_tpu.engine.distributed — multi-host bundle farms
"""

from audio_analysis_tpu.engine.distributed import (  # noqa: F401
    analyze_bundle_multi_host,
    initialize_multi_host,
)
from audio_analysis_tpu.engine.mesh import (  # noqa: F401
    analyze_batch_sharded,
    make_mesh,
    sharded_step,
)
from audio_analysis_tpu.parallel.overlap import (  # noqa: F401
    MaybePlotWorker,
    PlotWorker,
)
