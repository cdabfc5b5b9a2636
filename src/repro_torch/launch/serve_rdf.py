"""Online RDF serving demo (DESIGN §10): continuous batching under a latency
SLO with admission control, backpressure and shedding, over the port's
engine.

The port's counterpart of ``examples/serve_rdf.py``.  An open-loop Poisson
stream of LUBM template queries is driven through
``repro_torch.serving.ServeLoop`` on a virtual clock with a fixed
per-dispatch service model, so the run is a deterministic discrete-event
simulation (the engine's answers are computed on ``--device``; the
timeline is the model's).  Two runs are shown:

  * comfortable load: everything is answered, p99 well under the SLO;
  * overload (well past saturation): the bounded queue pushes back
    (``RetryAfter``), doomed requests are shed *before* execution
    (``SheddedResult``), the brownout ladder defers adaptivity work first,
    and the admitted requests still meet the SLO.

Run:  python -m repro_torch.launch.serve_rdf [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core.engine import AdHashEngine
from repro_torch.data.synthetic_rdf import Workload, lubm_like
from repro_torch.runtime.fault_injection import VirtualClock
from repro_torch.serving import (ServeConfig, ServeLoop, open_loop_arrivals,
                                 replay_open_loop)

__all__ = ["run", "main"]

SVC_S = 0.02           # modeled seconds per dispatched bucket
BATCH = 4              # continuous-batching target -> saturation 200 qps
SLO_S = 0.2


def run(rate_qps: float, label: str, device: str, n: int = 200) -> None:
    d, triples = lubm_like(n_universities=2, depts_per_univ=2,
                           profs_per_dept=2, students_per_prof=2)
    eng = AdHashEngine(triples, 8, adaptive=True, frequency_threshold=2,
                       capacity=256, device=device)
    loop = ServeLoop(
        eng,
        ServeConfig(slo_s=SLO_S, batch_target=BATCH, queue_bound=16,
                    bucket_window=16),
        clock=VirtualClock(), service_model=lambda _: SVC_S)
    qs = Workload(d, seed=5).sample(n)
    arrivals = open_loop_arrivals(qs, rate_qps=rate_qps, seed=5)
    replay_open_loop(loop, arrivals)

    r = loop.report
    print(f"\noffered {rate_qps:.0f} qps ({label}), "
          f"SLO {SLO_S * 1e3:.0f}ms:")
    print(f"  answered {r.answered}/{r.offered}  "
          f"(p50 {r.p50_s * 1e3:.0f}ms, p99 {r.p99_s * 1e3:.0f}ms, "
          f"late {r.late})")
    print(f"  shed {r.shed} ({r.shed_rate:.0%} of admitted)  "
          f"rejected {r.rejected} "
          f"(queue_full={r.rejected_queue_full} "
          f"brownout={r.rejected_brownout})")
    print(f"  brownout level changes: {len(r.brownout_events)}, "
          f"adaptivity deferrals: {r.adaptivity_deferrals}")
    print(f"  engine: {eng.report.n_queries} queries, "
          f"{eng.report.n_redistributions} IRD redistributions")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("deterministic serving DES: virtual clock, "
          f"{SVC_S * 1e3:.0f}ms/bucket, batch target {BATCH} "
          f"(upper-bound saturation {BATCH / SVC_S:.0f} qps; the mixed "
          "workload fragments shape buckets, so effective saturation is "
          f"lower); engine on {args.device}")
    run(rate_qps=30.0, label="comfortable", device=args.device)
    run(rate_qps=400.0, label="overload", device=args.device)


if __name__ == "__main__":
    main()
