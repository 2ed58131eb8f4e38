"""Checkpoint and resume of solver state.

Port of `ceres_tpu.checkpoint` (the reference has none: re-calling Solve
resumes, SURVEY.md §5): the parameter state, trust-region radius,
iteration and cost, saved atomically as .npz under the JAX package's keys
(state, trust_region_radius, iteration, cost), so a checkpoint written by
either package resumes a solve of the other on the same problem (both
Programs order the state vector the same way). `CheckpointCallback` saves
periodically during a solve (on the host loop: a solve with iteration
callbacks does not take the fused loop); `resume_problem_from` writes a
checkpoint's state into a Problem.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np

from .types import CallbackReturnType


@dataclasses.dataclass
class Checkpoint:
    state: np.ndarray
    trust_region_radius: float
    iteration: int
    cost: float

    def save(self, path: str):
        """Atomic write (a temporary file, then a rename): a crash never
        leaves a torn checkpoint."""
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f,
                    state=self.state,
                    trust_region_radius=np.float64(self.trust_region_radius),
                    iteration=np.int64(self.iteration),
                    cost=np.float64(self.cost),
                )
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str) -> "Checkpoint":
        with np.load(path) as z:
            return cls(
                state=np.asarray(z["state"]),
                trust_region_radius=float(z["trust_region_radius"]),
                iteration=int(z["iteration"]),
                cost=float(z["cost"]),
            )


class CheckpointCallback:
    """Iteration callback that saves the problem's state every `every`
    successful iterations. Put it in SolverOptions.callbacks with
    `update_state_every_iteration=True`, so that the Program's host state
    is the current iterate (the reference's StateUpdatingCallback)."""

    def __init__(self, problem, path: str, every: int = 10):
        self.problem = problem
        self.path = path
        self.every = max(1, every)

    def __call__(self, it_sum):
        if it_sum.iteration % self.every == 0 and it_sum.step_is_successful:
            Checkpoint(
                state=np.asarray(self.problem._lowered().state0),
                trust_region_radius=float(it_sum.trust_region_radius),
                iteration=int(it_sum.iteration),
                cost=float(it_sum.cost),
            ).save(self.path)
        return CallbackReturnType.SOLVER_CONTINUE


def resume_problem_from(problem, path: str) -> Checkpoint:
    """Load a checkpoint and write its state into the problem's blocks.
    Returns the checkpoint, whose radius can seed
    SolverOptions.initial_trust_region_radius."""
    ckpt = Checkpoint.load(path)
    program = problem._lowered()
    if ckpt.state.shape != (program.num_parameters,):
        raise ValueError(
            f"checkpoint state has shape {ckpt.state.shape}, the problem has "
            f"{program.num_parameters} parameters"
        )
    program.write_state_back(ckpt.state)
    return ckpt
