"""AdHash core, PyTorch port (ingest, plan, execute — one query or a batch
— answer, adapt).

Modules (each the counterpart of the same name in ``repro.core``):
  dictionary  string <-> id encoding (master, §3.1)
  partition   subject-hash partitioning (§3.1)
  placement   splitmix64 hash placement (owner = H(s) mod W)
  stats       per-predicate global statistics + Chauvenet filter (§3.3, §5.1)
  query       SPARQL BGP model
  backend     device selection, probe wrappers, capacity classes
  triples     worker storage: sorted P/PS/PO indexes (§3.2)
  relalg      fixed-capacity relational primitives (expand/compact/bucket)
  relation    fixed-capacity sharded intermediate results
  ingest      streaming bootstrap (one-shot == chunked)
  dsj         distributed semi-join stages (§4.1) + their batched variants
  substrate   single-device substrate + host-sync chokepoints
  tracing     host-sync counter, the engine's spans, stage row fill
  planner     DP cost-based optimizer (§4.2, §4.3)
  executor    locality-aware distributed execution (Algorithm 1), one query
              or one shape bucket
  batcher     workload shape-bucketing for batched multi-query execution
  health      worker health and the degraded-route predicate (DESIGN §9)
  transform   core-vertex selection + redistribution tree (Alg. 2, §5.1-5.2)
  heatmap     hierarchical workload heat map (§5.4)
  pattern_index  pattern index + replica index + LRU eviction (§5.5)
  ird         incremental redistribution (Algorithm 3, §5.3)
  engine      the engine facade (§3.4): adaptive AdHash, or AdHash-NA
  adaptive    the adaptivity loop for LM embedding rows (DESIGN §2b)
"""
