"""Speaker diarization on the port: SAD (oracle, energy, Silero), sliding
subsegment windows, spectral and density clustering, RTTM and DER.

Counterpart of `wespeaker_hubert_tpu/diar/`, with its `__all__`.  Torch,
numpy and scipy only: the k-means, the spectral embedding and HDBSCAN that
the JAX package takes from sklearn are the port's own.
"""

from .der import der, der_details
from .density import cluster as density_cluster
from .pahc import PAHC
from .rttm import merge_segments, read_labels_file, read_rttm, write_rttm
from .sad import energy_vad, oracle_sad, system_sad
from .spectral import cluster as spectral_cluster
from .subsegment import make_seg_id, parse_subseg_id, subsegment_fbank

__all__ = [
    "der",
    "der_details",
    "density_cluster",
    "PAHC",
    "merge_segments",
    "read_labels_file",
    "read_rttm",
    "write_rttm",
    "energy_vad",
    "oracle_sad",
    "system_sad",
    "spectral_cluster",
    "make_seg_id",
    "parse_subseg_id",
    "subsegment_fbank",
]
