"""Training-loop observability for the speaker encoder (port of
dvc_tpu/utils/visualizations.py).

Role parity with reference preprocessing/encoder/visualizations.py:27-177,
which streams loss/EER/step-time line plots to a visdom server and draws
periodic UMAP projections.  Neither visdom nor umap is a dependency: the
host-native equivalents are TensorBoard scalars (when
torch.utils.tensorboard imports) plus matplotlib PNGs refreshed in place
(when matplotlib imports) - the curves PNG is rewritten on every update
window - and projections use the deterministic PCA stand-in
(utils/plotting.projection_plot).  The text panels are JSON files.
"""

from __future__ import annotations

import datetime
import json
import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Visualizations:
    run_id: str = "ge2e"
    out_dir: str = ""
    update_every: int = 10
    disabled: bool = False

    losses: list = field(default_factory=list)
    eers: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    steps: list = field(default_factory=list)

    def __post_init__(self):
        self._writer = None
        if self.disabled:
            return
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # no tensorboard package: no scalars, as dvc_tpu
                return
            self._writer = SummaryWriter(os.path.join(self.out_dir, f"tb_{self.run_id}"))

    # -- text panels (reference log_params/log_dataset/log_implementation) ---

    def _log_text(self, name: str, payload: dict) -> None:
        if self.disabled or not self.out_dir:
            return
        path = os.path.join(self.out_dir, f"{self.run_id}_{name}.json")
        with open(path, "w") as f:
            json.dump({"time": datetime.datetime.now().isoformat(), **payload},
                      f, indent=2, default=str)

    def log_params(self, cfg) -> None:
        import dataclasses
        payload = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) \
            else dict(cfg)
        self._log_text("params", payload)

    def log_dataset(self, dataset_root: str, n_speakers: int) -> None:
        self._log_text("dataset", {"root": dataset_root,
                                   "n_speakers": n_speakers})

    def log_implementation(self, params: dict) -> None:
        self._log_text("implementation", params)

    # -- streaming scalars ----------------------------------------------------

    def update(self, loss: float, eer: float, step_time_s: float,
               step: int) -> None:
        """Buffer one window's means and refresh the curves (reference
        visualizations.py:100-140 update())."""
        if self.disabled:
            return
        self.steps.append(int(step))
        self.losses.append(float(loss))
        self.eers.append(float(eer))
        self.step_times.append(float(step_time_s) * 1000.0)
        if self._writer is not None:
            self._writer.add_scalar("GE2E/loss", loss, step)
            self._writer.add_scalar("GE2E/EER", eer, step)
            self._writer.add_scalar("GE2E/step_ms", step_time_s * 1000.0, step)
        if self.out_dir and (len(self.steps) % max(1, self.update_every // 10)
                             == 0 or len(self.steps) == 1):
            self._draw_curves()

    def _draw_curves(self) -> bool:
        from dvc_tpu_torch.utils.plotting import _plt
        plt = _plt()
        if plt is None:
            return False
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        for ax, ys, name in zip(
                axes, (self.losses, self.eers, self.step_times),
                ("loss", "EER", "step time (ms)")):
            ax.plot(self.steps, ys)
            ax.set_title(f"{name} ({self.run_id})")
            ax.set_xlabel("step")
            ax.grid(alpha=0.3)
        fig.tight_layout()
        fig.savefig(os.path.join(self.out_dir, f"{self.run_id}_curves.png"))
        plt.close(fig)
        return True

    # -- projections (reference draw_projections, visualizations.py:155-173) --

    def draw_projections(self, embeds: np.ndarray, utterances_per_speaker: int,
                         step: int, max_speakers: int = 10) -> str | None:
        if self.disabled or not self.out_dir:
            return None
        from dvc_tpu_torch.utils.plotting import projection_plot
        n_spk = min(max_speakers, len(embeds) // utterances_per_speaker)
        e = np.asarray(embeds)[: n_spk * utterances_per_speaker]
        labels = np.repeat(np.arange(n_spk), utterances_per_speaker)
        path = os.path.join(self.out_dir,
                            f"{self.run_id}_umap_{int(step):06d}.png")
        if projection_plot(e, labels, path,
                           title=f"{self.run_id} projections (step {step})"):
            return path
        return None

    def save(self) -> None:
        if not self.disabled and self.out_dir:
            self._draw_curves()
        if self._writer is not None:
            self._writer.flush()
