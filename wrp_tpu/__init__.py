"""wrp_tpu — polarimetric pulse-Doppler weather-radar processing on the GPU.

A from-scratch JAX/XLA framework with the full capability surface of
the reference CUDA/C++ codebase (rsatrioadi/weather-radar-processing):
IQ ingest -> Hamming window -> range FFT -> Doppler processing -> matched
filter -> reflectivity (zdb) and differential reflectivity (zdr), with
streaming network ingest/egress, multi-chip sharding, and golden-validated
numerics.
"""

from .config import RadarConfig, DEFAULT_CONFIG, tiny_config  # noqa: F401
from .constants import PipelineConstants  # noqa: F401
from .pipeline import SectorProcessor, process_sectors  # noqa: F401

__version__ = "0.1.0"
