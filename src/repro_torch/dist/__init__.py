"""Distribution layer: how cached, pre-processed data becomes a production
workload across many devices.

Four submodules, each one concern:

- :mod:`repro_torch.dist.sharding` — logical-axis sharding constraints.  Model code
  annotates tensors with *logical* axis names (``"batch"``, ``"act_heads"``,
  ``"embed"`` …); a :class:`~repro_torch.dist.sharding.MeshRules` maps those to
  physical mesh axes, activated with
  :func:`~repro_torch.dist.sharding.use_rules`.  Two hazard rules are applied per
  dim (both diagnosed on the production meshes, EXPERIMENTS §Perf):
  **size-1 dims drop their constraint** (parking a length-1 dim on a >1
  axis makes one device the owner and every consumer a broadcast — the Z4
  owner-broadcast pathology), while **non-divisible dims keep theirs**
  (GSPMD pads; dropping the constraint silently replicates the buffer —
  the L1 six-heads-on-a-four-way-axis pathology).

- :mod:`repro_torch.dist.compression` — int8 error-feedback gradient compression
  for the data-parallel all-reduce wire format: per-tensor symmetric
  quantization, with the residual carried forward in an error buffer so the
  *sum* of compressed gradients tracks the sum of true gradients to within
  one quantization step.

- :mod:`repro_torch.dist.fault` — the failure → rollback → exact-replay control
  loop: :class:`~repro_torch.dist.fault.HeartbeatMonitor` (deadline-based failure
  detection; dead workers stay dead until revived — zombie beats are
  ignored), :class:`~repro_torch.dist.fault.StragglerDetector` (robust z-score
  over per-worker step times with a patience window, so one GC pause is not
  a restart), and :class:`~repro_torch.dist.fault.RestartCoordinator` (rolls back
  to the latest checkpoint and revives the failed workers).  Everything is
  driven by an injectable clock (:class:`~repro_torch.dist.fault.SimClock`) so the
  whole loop is testable in simulated time.

- :mod:`repro_torch.dist.pipeline` — microbatched pipeline parallelism over a
  mesh axis: parameters are stacked into per-stage slices and microbatches
  stream through the stages via ``ppermute``.  ``pipeline_forward`` is the
  forward-only GPipe stream (``M + S - 1`` ticks, bubble
  ``(S-1)/(M+S-1)``); ``pipeline_value_and_grad`` runs the **1F1B
  training schedule** — a real VJP backward with per-stage float32
  gradient accumulation, where each stage stashes only its in-flight
  microbatch inputs (``O(S)`` slots vs GPipe's ``O(M)``) and remats the
  stage forward inside the backward tick.  Both are numerically equal to
  the sequential layer stack; ``repro_torch.train.loop.make_pipeline_train_step``
  wraps the schedule in the standard ``(state, batch) -> (state, metrics)``
  contract so ``train_loop``/checkpointing work unchanged.
"""
