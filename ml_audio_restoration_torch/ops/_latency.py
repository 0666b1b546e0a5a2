"""Latency floors of the recurrence kernels K1, K2 and K3 (and the DADD
latency the IIR scan's floor is counted from).

`csrc/latency_probe.cu` times the building blocks of a recurrence step on
the card (cycles of a dependent chain of each); `floor_cycles` counts from
them the cycles a step of each kernel needs at the least, and `step_floor`
runs the probe and turns those cycles into time at the SM clock. A
measurement tool of chip_smoke.py and scripts/torch_lstm_ablation.py: no
model path calls it. Nothing here runs at import time.
"""
from __future__ import annotations

import subprocess

from . import _build

CHAINS = ("ffma", "fadd", "gate_act", "shfl_fadd", "sts_bar_lds_fadd")
PROBED = CHAINS + ("dadd",)  # the chains the probe times, in its order
PROBE = "latency_probe"  # csrc/latency_probe.cu


def floor_cycles(lat: dict, hidden: int) -> dict:
    """Cycles a step of each redesigned kernel needs if every instruction
    on its critical path issued the moment its operands were ready: the
    chain of dependent operations counted from the sources, at the measured
    latencies `lat` (cycles, keyed by CHAINS), with the h @ W_hh (K1) or
    d_lin @ W_hh^T (K3) products at the larger of their FMA issue time
    (H * 4H FMAs on the SM's 128 f32 lanes) and their dependent depth (16
    FMAs an accumulator at H = 64). K2's chain is K1's: its residual stores
    depend on the step's values but nothing on the chain waits for them."""
    fma = max(hidden * 4 * hidden / 128, (hidden // 4) * lat["ffma"])
    shfl = lat["shfl_fadd"] - lat["fadd"]
    k1 = (lat["sts_bar_lds_fadd"] + fma + lat["fadd"]    # h in, product
          + lat["shfl_fadd"]                            # reduce_gates
          + lat["fadd"] + lat["gate_act"]               # + gx, activate
          + shfl                                        # gather i, f, g, o
          + 2 * lat["ffma"] + lat["gate_act"]           # c, tanh(c)
          + lat["ffma"])                                # h
    k3 = (lat["sts_bar_lds_fadd"] + fma                 # d_lin in, product
          + 3 * lat["fadd"] + lat["shfl_fadd"]          # tree, butterfly
          + lat["fadd"] + 2 * lat["ffma"]               # dh_tot, dct
          + 2 * lat["ffma"])                            # d_lin
    return {"k1": k1, "k2": k1, "k3": k3}


def step_floor(hidden: int, steps: dict, dev) -> dict:
    """Runs the probe on `dev` (building it at first use) and counts each
    kernel's floor: {"latency_cycles", "sm_clock", "sm_ghz", "floor":
    {kernel: {cycles_per_step, ns_per_step, ms at steps[kernel]}}}. The SM
    clock is nvidia-smi's reading right after the probe."""
    import torch

    from . import lstm as L

    n = 4096
    cycles = torch.zeros(len(PROBED), dtype=torch.int64, device=dev)
    sink = torch.empty(128, device=dev)
    L._launch(PROBE, _build.load(PROBE).latency, 2, 1,
              [cycles.data_ptr(), sink.data_ptr(), n], dev)
    lat = dict(zip(PROBED, (cycles.cpu().double() / n).tolist()))
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60).stdout.strip()
    ghz = float(clock.split(",")[0].split()[0]) / 1e3
    floor = {k: {"cycles_per_step": c, "ns_per_step": c / ghz,
                 "ms": c / ghz * steps[k] * 1e-6}
             for k, c in floor_cycles(lat, hidden).items()}
    return {"latency_cycles": lat, "sm_clock": clock, "sm_ghz": ghz,
            "floor": floor}
