"""The HTTP fronts and TLS on the card: ``chip_smoke.py``'s phase 47 alone.

Runs what phase 47 needs of the script first: the kernels' build, phase 4
(the full-width text model), phase 5 (its served answers, which 47.1
holds every answer to), phase 38 (the stored classification instances on
SQLite) and phase 39 (the threaded pool of 4 whose numbers 47.2 stands
beside). Then phase 47: phase 4's model on the threaded and the evloop
front from 1 and 32 clients and a pipelined burst, phase 39's pool on the
evloop front, TLS on the threaded front::

    python3 scripts/torch_fronts.py

Prints the card's name and power limit first and one ``P47`` JSON line
last. Exits 1 without a CUDA device or when a phase fails.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pio_tpu_torch.ops import _build  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fronts: no CUDA device available", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    for name, b in _build.build_all().items():
        print(f"{name} built in {b.seconds:.1f} s", flush=True)
    cs.use_memory_storage()
    os.environ["PIO_TPU_HOME"] = cs.fresh_home("script")
    gpu, cpu, queries = cs.phase_model(args)
    _, http_answers = cs.phase_http(gpu, cpu, queries)
    reloaded = cs.phase_reload_under_load(args, smi)
    pool39 = cs.phase_pool(args, smi, reloaded)
    out = cs.phase_fronts(args, smi, gpu, queries, http_answers, reloaded,
                          pool39)
    print(f"torch_fronts: {time.monotonic() - t0:.1f} s", flush=True)
    print("P47 " + json.dumps({
        "fronts": out["fronts"], "pool": out["pool"]["latency"],
        "pool39": pool39["latency"], "launches": out["launches"],
        "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
