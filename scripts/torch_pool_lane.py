"""Where a ``--device-worker`` pool serves its queries, at two lane timeouts.

Runs ``chip_smoke.py``'s phase 46 (the pool plane and the router over the
text-classification template at full width) after what it needs of the
script: the kernels' build and phase 29 (``pio train`` and ``deploy`` of
the text engine), plus a second ``pio train`` for the rollouts'
candidate. Phase 46 then runs once for each ``--timeouts`` value of
``PIO_TPU_LANE_TIMEOUT_S`` (the reference's default is 0.25 s; phase 46
uses 5 s). Each run logs both pools' lane blocks: every sibling's
enqueued queries and its fallbacks by reason (a query the sibling served
on its own CPU), and worker 0's drained count. A run whose pools fell
back fails phase 46, is reported, and does not stop the next run::

    python3 scripts/torch_pool_lane.py --timeouts 0.25,5

Prints the card's name and power limit first, and one ``P46`` line a run.
Exits 1 when a run other than the first failed, or without a CUDA device.
"""

import argparse
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pio_tpu_torch.ops import _build  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeouts", default="0.25,5",
                    help="lane timeouts in seconds, one phase 46 run each")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_pool_lane: no CUDA device available", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    for name, b in _build.build_all().items():
        print(f"{name} built in {b.seconds:.1f} s", flush=True)
    cs.use_memory_storage()
    os.environ["PIO_TPU_HOME"] = cs.fresh_home("script")
    text = cs.phase_cli_text(args, smi)
    with cs.cli_store(text["home"]):
        if cs.cli_main(["train", "--engine-json", text["engine_json"]]) != 0:
            raise AssertionError("the second pio train failed")
    rc = 0
    for k, timeout in enumerate(float(t) for t in args.timeouts.split(",")):
        cs.P46_LANE_TIMEOUT_S = timeout
        try:
            out = cs.phase_pool_plane(args, smi, text)
            print(f"P46 lane timeout {timeout} s: passed; lanes "
                  f"{out['pool']['lanes']}; pool {out['pool']['latency']}; "
                  f"QoS pool {out['pool']['qos']}; launches "
                  f"{out['launches']}; {smi}", flush=True)
        except AssertionError:
            traceback.print_exc()
            print(f"P46 lane timeout {timeout} s: failed; {smi}", flush=True)
            rc = rc or int(k > 0)
    print(f"torch_pool_lane: {time.monotonic() - t0:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
