#!/usr/bin/env python3
"""How often torch.profiler drops device records of a profile window, on
the card, with and without the idle lead-in of `measure.device_ms`.

    python3 profile_probe.py [seconds]

Builds the kernels and `chip_smoke.py`'s 100k / 500 / 12 network, then for
``seconds`` (default 240) profiles windows of 50 K1 calls
(`kernels.schur_matvec_rows`) between two marker fills, in turns with no
idle host time in the window and with `measure.PROFILE_LEAD_S` before and
after the work (as `measure.device_ms` profiles).  A window is short when
it holds fewer than 50 K1 records; its first record then says whether the
start of the window was lost (not the first marker).  Prints the card's
name and power limit, then one JSON line with the counts per kind of
window and the first short windows.
"""

import json
import subprocess
import sys
import time

REPS = 50            # K1 calls per window


def main(seconds=240.0):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_probe.py needs a GPU (torch.cuda.is_available() "
                 "is false)")
    from bundle_adjustment_tpu_torch import (convert, kernel_build, measure,
                                             synthetic)
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    kernel_build.build()
    dev = torch.device("cuda", 0)
    ph, sh, spec = synthetic.build_problem(100_000, 500, 12, seed=0)
    prob = convert.problem_to_torch(ph, dev, torch.float32)
    st = convert.state_to_torch(sh, dev, torch.float32)
    fmp = engine.fm_problem(prob)
    fv = kernels.kernel_layout(fmp)
    b = engine.linearize(fv, st, spec, 1e-2)
    pp = kernels.pack_fm(b, fv, with_pw=True)
    fin = engine.finish_reduction(fv, b, st, 1e-2,
                                  *kernels.prepare_reduction(pp), True)
    ec, eg = fin[0].extra_c.contiguous(), fin[0].extra_g.contiguous()
    gen = torch.Generator().manual_seed(1)
    xc = torch.randn((fv.num_images, 6), generator=gen).to(dev)
    xg = torch.randn((pp.g,), generator=gen).to(dev)
    marker = torch.zeros(1 << 20, device=dev)

    def window(lead_s):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            time.sleep(lead_s)
            marker.fill_(1.0)
            for _ in range(REPS):
                kernels.schur_matvec_rows(pp, ec, eg, xc, xg)
            marker.fill_(2.0)
            torch.cuda.synchronize()
            time.sleep(lead_s)
        ev = sorted((e for e in p.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        k1 = sum("matvec_kernel" in e.name for e in ev)
        return k1, bool(ev) and "Fill" in ev[0].name

    kinds = {"no_lead": 0.0, "lead": measure.PROFILE_LEAD_S}
    counts = {k: dict(windows=0, short=0, start_lost=0) for k in kinds}
    short = []
    t0 = time.time()
    while time.time() - t0 < seconds:
        for kind, lead_s in kinds.items():
            k1, first_is_marker = window(lead_s)
            c = counts[kind]
            c["windows"] += 1
            if k1 != REPS:
                c["short"] += 1
                c["start_lost"] += not first_is_marker
                if len(short) < 20:
                    short.append(dict(kind=kind, at_s=time.time() - t0,
                                      k1_records=k1))
    print(json.dumps({"reps": REPS, "lead_s": measure.PROFILE_LEAD_S,
                      "seconds": time.time() - t0, "counts": counts,
                      "short": short}))


if __name__ == "__main__":
    main(float(sys.argv[1]) if len(sys.argv) > 1 else 240.0)
