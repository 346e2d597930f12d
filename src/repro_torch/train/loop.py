"""Supervised training loop (port of ``repro/train/loop.py``): data
pipeline, train step, metrics, bounded retry.

- **Resume order**: the loop starts at ``state.step`` and fast-forwards the
  data pipeline to exactly that point (``DataPipeline.locate`` +
  ``epoch(e, skip=n)``).
- **Bounded retry**: a step that raises is retried up to ``max_retries``
  times with exponential backoff, re-running the same batch from the held
  state.  If the failure came while the optimizer was writing the state in
  place (``state.in_update``), the error propagates instead.
- Checkpointing and the watchdog are not ported yet: ``ckpt_dir`` or
  ``watchdog_timeout_s`` raise, naming ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

from repro_torch.data.pipeline import DataPipeline

FAULT_TOLERANCE = "ROADMAP.md Queue 1 item 9 (fault tolerance and checkpoints)"


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    log_every: int = 20
    ckpt_dir: str = ""              # not ported: raises
    target_loss: Optional[float] = None
    max_retries: int = 0            # bounded per-step retries
    retry_backoff_s: float = 0.05   # exponential backoff base
    watchdog_timeout_s: float = 0.0  # not ported: > 0 raises


def train_loop(train_step: Callable, state, pipeline: DataPipeline,
               cfg: LoopConfig, *, log_fn: Callable[[str], None] = print) -> Dict:
    """Runs from ``state.step`` up to cfg.total_steps (or until
    target_loss).  Returns a summary dict."""
    if cfg.ckpt_dir:
        raise NotImplementedError(f"checkpoints are not ported to repro_torch yet: "
                                  f"{FAULT_TOLERANCE}")
    if cfg.watchdog_timeout_s > 0:
        raise NotImplementedError(f"the step watchdog is not ported to repro_torch "
                                  f"yet: {FAULT_TOLERANCE}")
    start = int(state.step)
    step = start
    epoch, skip = pipeline.locate(start)
    if start:
        log_fn(f"[loop] resuming at step {start} "
               f"(epoch {epoch}, skipping {skip} batches)")

    losses, history = [], []
    retries = 0
    converged = False
    t0 = time.time()
    t_last, s_last = t0, step

    def run_step(batch):
        nonlocal retries
        attempt = 0
        while True:
            try:
                new_state, metrics = train_step(state, batch)
                return new_state, metrics, float(metrics["loss"])
            except Exception as e:
                if attempt >= cfg.max_retries or state.in_update:
                    raise
                attempt += 1
                retries += 1
                delay = cfg.retry_backoff_s * (2 ** (attempt - 1))
                log_fn(f"[loop] step {step + 1} failed "
                       f"({type(e).__name__}: {e}); retry "
                       f"{attempt}/{cfg.max_retries} in {delay:.2f}s")
                time.sleep(delay)

    while step < cfg.total_steps:
        n_in_epoch = 0
        for batch in pipeline.epoch(epoch, skip=skip):
            n_in_epoch += 1
            state, metrics, loss = run_step(batch)
            step += 1
            losses.append(loss)
            history.append(loss)
            if step % cfg.log_every == 0:
                now = time.time()
                rate = (step - s_last) / max(now - t_last, 1e-9)
                t_last, s_last = now, step
                log_fn(f"step {step:6d} epoch {epoch:3d} "
                       f"loss {sum(losses)/len(losses):7.4f} "
                       f"{rate:6.2f} steps/s")
                losses = []
            if step >= cfg.total_steps:
                break
            if cfg.target_loss is not None and loss <= cfg.target_loss:
                converged = True
                break
        if converged or step >= cfg.total_steps:
            break
        if n_in_epoch == 0 and skip == 0:
            raise RuntimeError(
                f"data pipeline yielded an empty epoch ({epoch}) with "
                f"{cfg.total_steps - step} steps still to run — the "
                f"dataset/batch combination produces no batches")
        epoch += 1
        skip = 0

    return {"state": state, "steps": step, "epochs": epoch,
            "final_loss": history[-1] if history else float("nan"),
            "history": history, "wall_s": time.time() - t0,
            "converged": converged, "start_step": start, "retries": retries}
