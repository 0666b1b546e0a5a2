"""The numbers that decide `correct`."""
from __future__ import annotations

import statistics

import torch


def peak_gap(program, reference) -> float:
    """The widest gap between two outputs over the reference's peak."""
    program = program.to(reference.device, torch.float32)
    if program.shape != reference.shape:
        return float("inf")
    return float((program - reference).abs().max()
                 / reference.abs().max().clamp(min=1e-30))


def rms_gap(program, reference) -> float:
    """The root-mean-square gap between two outputs over the reference's
    root mean square."""
    program = program.to(reference.device, torch.float32)
    if program.shape != reference.shape:
        return float("inf")
    return float((program - reference).pow(2).mean().sqrt()
                 / reference.pow(2).mean().sqrt().clamp(min=1e-30))


def norm_gap(program: dict, reference: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger. `keep` limits the leaves compared."""
    names = [k for k in reference if keep is None or k in keep]
    ref = {k: float(torch.linalg.vector_norm(reference[k].float()))
           for k in names}
    median = statistics.median(ref.values())
    worst = 0.0
    for k in names:
        prog = float(torch.linalg.vector_norm(program[k].float()))
        worst = max(worst, abs(prog - ref[k]) / max(ref[k], median, 1e-30))
    return worst


def median_gap(program: dict, reference: dict, keep=None) -> float:
    """The median leaf's gap between the program's norm and the
    reference's, relative to the reference's norm of that leaf."""
    names = [k for k in reference if keep is None or k in keep]
    gaps = []
    for k in names:
        ref = float(torch.linalg.vector_norm(reference[k].float()))
        prog = float(torch.linalg.vector_norm(program[k].float()))
        gaps.append(abs(prog - ref) / max(ref, 1e-30))
    return statistics.median(gaps)
