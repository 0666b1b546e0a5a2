"""Training losses of the port (channels-last [B, T, C], as in the JAX
package), counterpart of ml_audio_restoration_tpu/losses/. The
transient spectral loss is not ported yet.
"""
import torch

from .impulse import impulse_loss
from .metrics import lsd, si_sdr, snr
from .semi_supervised import (
    consistency_loss, contrastive_loss, cycle_consistency_loss,
    semi_supervised_loss, supervised_loss)
from .spectral import FFT_SIZES, LOG_EPS, multiscale_spectral_loss
from .stereo import (
    decorrelation_loss,
    low_frequency_centering_loss,
    spectral_clustering_loss,
    stereo_balance_loss,
    stereo_metrics,
    stereo_stats_match_loss,
    temporal_consistency_loss,
)

# Reference Trainer loss weights
SPECTRAL_WEIGHT = 0.5
IMPULSE_WEIGHT = 0.3
CLUSTERING_WEIGHT = 0.1
CONSISTENCY_WEIGHT = 0.05


def restoration_loss(output, target, *,
                     time_weight: float = 1.0,
                     spectral_weight: float = SPECTRAL_WEIGHT,
                     impulse_weight: float = IMPULSE_WEIGHT,
                     clustering_weight: float = CLUSTERING_WEIGHT,
                     consistency_weight: float = CONSISTENCY_WEIGHT,
                     balance_weight: float = 0.0,
                     decorrelation_weight: float = 0.0,
                     lf_centering_weight: float = 0.0,
                     stats_match_weight: float = 0.0,
                     si_sdr_weight: float = 0.0):
    """The combined per-batch training loss: time MSE + 0.5 x multi-scale
    spectral, plus the impulse loss for mono output or spectral clustering
    + temporal consistency for stereo output, plus the optional terms whose
    weights are above 0. Returns (total, components dict)."""
    time_loss = torch.mean(torch.square(output - target))
    spec = multiscale_spectral_loss(output, target)
    recon = time_weight * time_loss + spectral_weight * spec
    parts = {"time": time_loss, "spectral": spec}
    if si_sdr_weight > 0:
        sdr = torch.mean(si_sdr(output, target, axis=1))
        parts["si_sdr_db"] = sdr
        recon = recon + si_sdr_weight * (-sdr)
    if output.shape[-1] == 1:
        imp = impulse_loss(output, target)
        parts["impulse"] = imp
        total = recon + impulse_weight * imp
    else:
        clus = spectral_clustering_loss(output)
        cons = temporal_consistency_loss(output)
        parts["clustering"] = clus
        parts["consistency"] = cons
        total = recon + clustering_weight * clus + consistency_weight * cons
        if balance_weight > 0:
            bal = stereo_balance_loss(output, target)
            parts["balance"] = bal
            total = total + balance_weight * bal
        if decorrelation_weight > 0:
            dec = decorrelation_loss(output)
            parts["decorrelation"] = dec
            total = total + decorrelation_weight * dec
        if lf_centering_weight > 0:
            lfc = low_frequency_centering_loss(output)
            parts["lf_centering"] = lfc
            total = total + lf_centering_weight * lfc
        if stats_match_weight > 0:
            sm = stereo_stats_match_loss(output, target)
            parts["stats_match"] = sm
            total = total + stats_match_weight * sm
    parts["total"] = total
    return total, parts


__all__ = [
    "FFT_SIZES", "LOG_EPS", "consistency_loss", "contrastive_loss",
    "cycle_consistency_loss", "decorrelation_loss", "impulse_loss",
    "low_frequency_centering_loss", "lsd", "multiscale_spectral_loss",
    "restoration_loss", "semi_supervised_loss", "si_sdr", "snr",
    "spectral_clustering_loss", "stereo_balance_loss", "stereo_metrics",
    "stereo_stats_match_loss", "supervised_loss",
    "temporal_consistency_loss",
]
