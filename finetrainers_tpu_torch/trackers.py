"""Experiment trackers (port of `finetrainers_tpu/trackers.py`): the no-op
`BaseTracker` with the `timed` spans that accumulate `timing/*` seconds into
the next `log`, `JSONLTracker` (one JSON object per line under
`output_dir/logging_dir`), `WandbTracker` (when `wandb` imports; otherwise
`initialize_trackers` falls back to JSONL) and `SequentialTracker`."""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Union

from .logging import get_logger
from .utils.timing import timed


logger = get_logger(__name__)


class BaseTracker:
    """No-op tracker: `timed` still accumulates, `log` drops."""

    def __init__(self) -> None:
        self._timed_metrics: Dict[str, float] = {}
        self._lock = threading.Lock()  # a prefetch thread times its precompute while the loop logs

    def timed(self, name: str):
        """A span whose seconds are added to `timing/<name>` of the next `log`."""
        return timed(self._timed_metrics, name if name.startswith("timing/") else f"timing/{name}", self._lock)

    def _consume_timed(self) -> Dict[str, float]:
        with self._lock:
            metrics = dict(self._timed_metrics)
            self._timed_metrics.clear()  # the same dict: a span still open adds to it
        return metrics

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        pass

    def log_artifacts(self, artifacts: List[Dict[str, Any]], step: int) -> None:
        """Validation media: [{"type": "image"|"video", "path": str, "caption": str}]."""

    def finish(self) -> None:
        pass


class JSONLTracker(BaseTracker):
    """Appends scalar metrics (numbers and strings) to `<log_dir>/<experiment_name>.jsonl`."""

    def __init__(self, experiment_name: str, log_dir: str) -> None:
        super().__init__()
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{experiment_name}.jsonl")
        self._file = open(self.path, "a")

    def _write(self, entry: Dict[str, Any]) -> None:
        self._file.write(json.dumps(entry) + "\n")
        self._file.flush()

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        metrics = {**metrics, **self._consume_timed()}
        self._write({"step": step, **{k: v for k, v in metrics.items() if isinstance(v, (int, float, str))}})

    def log_artifacts(self, artifacts: List[Dict[str, Any]], step: int) -> None:
        entry = {f"validation/artifact_{i}": a.get("path", "") for i, a in enumerate(artifacts)}
        entry.update({f"validation/caption_{i}": a["caption"] for i, a in enumerate(artifacts) if a.get("caption")})
        if entry:
            self._write({"step": step, **entry})

    def finish(self) -> None:
        self._file.close()


class WandbTracker(BaseTracker):
    def __init__(self, experiment_name: str, log_dir: str, config: Optional[Dict[str, Any]] = None) -> None:
        super().__init__()
        import wandb

        self.wandb = wandb
        os.makedirs(log_dir, exist_ok=True)
        self.run = wandb.init(project=experiment_name, dir=log_dir, config=config)

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        self.run.log({**metrics, **self._consume_timed()}, step=step)

    def log_artifacts(self, artifacts: List[Dict[str, Any]], step: int) -> None:
        panel = {}
        for kind, cls in (("image", self.wandb.Image), ("video", self.wandb.Video)):
            media = [cls(a["path"], caption=a.get("caption")) for a in artifacts if a.get("type") == kind]
            if media:
                panel[f"validation/{kind}s"] = media
        if panel:
            self.run.log(panel, step=step)

    def finish(self) -> None:
        self.run.finish()


class SequentialTracker(BaseTracker):
    def __init__(self, trackers: List[BaseTracker]) -> None:
        super().__init__()
        self.trackers = trackers

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        timings = self._consume_timed()
        for tracker in self.trackers:
            tracker.log({**metrics, **timings}, step)

    def log_artifacts(self, artifacts: List[Dict[str, Any]], step: int) -> None:
        for tracker in self.trackers:
            tracker.log_artifacts(artifacts, step)

    def finish(self) -> None:
        for tracker in self.trackers:
            tracker.finish()


def initialize_trackers(trackers: Union[str, List[str]], experiment_name: str,
                        config: Optional[Dict[str, Any]] = None, log_dir: str = "logs") -> BaseTracker:
    """Trackers by name ("none", "jsonl", "wandb"); `wandb` falls back to
    JSONL where the package is missing."""
    instances: List[BaseTracker] = []
    for name in [trackers] if isinstance(trackers, str) else trackers:
        if name in ("none", None):
            continue
        if name == "wandb":
            try:
                instances.append(WandbTracker(experiment_name, log_dir, config))
            except ImportError:
                logger.warning("wandb is not installed; falling back to the JSONL tracker.")
                instances.append(JSONLTracker(experiment_name, log_dir))
        elif name == "jsonl":
            instances.append(JSONLTracker(experiment_name, log_dir))
        else:
            raise ValueError(f"Unsupported tracker: {name}")
    if not instances:
        return BaseTracker()
    return instances[0] if len(instances) == 1 else SequentialTracker(instances)
