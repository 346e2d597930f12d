"""Supervised training loop (port of ``repro/train/loop.py``): data
pipeline, train step, metrics, checkpoints and failure handling.

The loop is the inner layer of the fault-tolerance stack (the outer layer,
process-level restarts and checkpoint fallback, is ``train.fault.
run_supervised``):

- **Resume** is implicit: the loop starts at ``state.step`` and
  fast-forwards the data pipeline to exactly that point
  (``DataPipeline.locate`` + ``epoch(e, skip=n)``), so a restored run
  consumes precisely the batches an uninterrupted run would have, which is
  what makes kill-and-resume bit-equal to a straight run on the same
  topology.
- **Bounded retry**: a step that raises is retried up to ``max_retries``
  times with exponential backoff, re-running the same batch from the held
  state.  If the failure came while the optimizer was writing the state in
  place (``state.in_update``, the port's counterpart of JAX's donated
  buffers), the error propagates instead: only a checkpoint restore can
  recover, the supervisor's job.
- **Watchdog**: ``watchdog_timeout_s > 0`` arms a timer around every step;
  a step exceeding it is flagged (logged and counted in the summary), never
  killed.
- **Checkpointing**: every ``ckpt_every`` steps (``keep_last`` retention,
  ``background_save`` moving the write off the step path) plus a guaranteed
  synchronous final checkpoint at loop exit, so the exit state is always
  resumable.  ``save`` is the caller's saver (on ranks, every rank gathers
  the global state and one writes: ``train.steps.checkpoint_saver``); it
  defaults to ``checkpoint.save_checkpoint`` of the state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

from repro_torch.checkpoint import save_checkpoint, wait_for_saves
from repro_torch.data.pipeline import DataPipeline


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    log_every: int = 20
    ckpt_every: int = 0
    ckpt_dir: str = ""
    target_loss: Optional[float] = None
    keep_last: int = 0              # checkpoint retention (0 = keep all)
    background_save: bool = False   # serialize + write off the step path
    final_ckpt: bool = True         # guaranteed checkpoint at loop exit
    max_retries: int = 0            # bounded per-step retries
    retry_backoff_s: float = 0.05   # exponential backoff base
    watchdog_timeout_s: float = 0.0  # > 0: flag steps exceeding this


def train_loop(train_step: Callable, state, pipeline: DataPipeline,
               cfg: LoopConfig, *, log_fn: Callable[[str], None] = print,
               on_checkpoint: Optional[Callable[[str, int], None]] = None,
               save: Optional[Callable] = None) -> Dict:
    """Runs from ``state.step`` up to cfg.total_steps (or until
    target_loss).  Returns a summary dict; see the module docstring for the
    failure handling.  ``on_checkpoint(fname, step)`` fires after each
    completed checkpoint write (the fault-injection hook); ``save(path,
    state, step, *, keep_last, background) -> fname`` writes one."""
    save = save or save_checkpoint
    start = int(state.step)
    step = start
    epoch, skip = pipeline.locate(start)
    if start:
        log_fn(f"[loop] resuming at step {start} "
               f"(epoch {epoch}, skipping {skip} batches)")

    losses, history = [], []
    retries = hangs = n_ckpts = 0
    last_saved = None
    converged = False
    t0 = time.time()
    t_last, s_last = t0, step

    watchdog = None
    if cfg.watchdog_timeout_s > 0:
        from repro_torch.train.fault import Watchdog

        def flag(tag):
            nonlocal hangs
            hangs += 1
            log_fn(f"[watchdog] step {tag} exceeded "
                   f"{cfg.watchdog_timeout_s:.2f}s — flagging hang")

        watchdog = Watchdog(cfg.watchdog_timeout_s, on_timeout=flag)

    def checkpoint(at_step: int, background: bool):
        nonlocal last_saved, n_ckpts
        fname = save(cfg.ckpt_dir, state, at_step, keep_last=cfg.keep_last,
                     background=background)
        last_saved = at_step
        n_ckpts += 1
        if on_checkpoint is not None:
            if background:
                wait_for_saves()    # the hook inspects the finished file
            on_checkpoint(fname, at_step)

    def run_step(batch):
        nonlocal retries
        attempt = 0
        while True:
            try:
                if watchdog:
                    watchdog.arm(step + 1)
                new_state, metrics = train_step(state, batch)
                loss = float(metrics["loss"])   # sync inside the watchdog window
                return new_state, metrics, loss
            except Exception as e:
                if watchdog:
                    watchdog.disarm()    # before the backoff sleep
                if attempt >= cfg.max_retries or state.in_update:
                    raise
                attempt += 1
                retries += 1
                delay = cfg.retry_backoff_s * (2 ** (attempt - 1))
                log_fn(f"[loop] step {step + 1} failed "
                       f"({type(e).__name__}: {e}); retry "
                       f"{attempt}/{cfg.max_retries} in {delay:.2f}s")
                time.sleep(delay)
            finally:
                if watchdog:
                    watchdog.disarm()

    try:
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
                if cfg.ckpt_every and cfg.ckpt_dir and step % cfg.ckpt_every == 0:
                    checkpoint(step, cfg.background_save)
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
        # guaranteed final checkpoint: the exit state is always resumable
        if cfg.ckpt_dir and cfg.final_ckpt and step > start and last_saved != step:
            checkpoint(step, background=False)
    finally:
        if cfg.background_save:
            wait_for_saves()
        if watchdog:
            watchdog.close()

    return {"state": state, "steps": step, "epochs": epoch,
            "final_loss": history[-1] if history else float("nan"),
            "history": history, "wall_s": time.time() - t0,
            "converged": converged, "start_step": start,
            "retries": retries, "hangs": hangs, "checkpoints": n_ckpts,
            "last_checkpoint_step": last_saved}
