"""``BENCHMARK.json`` and the files it names.

Every configuration, traffic mix, metric and limit lives in a file of its
own that the harness finds by its name:

- ``configs/<config>.json``, ``traffic/<traffic>.json``;
- ``metrics/<metric>.py``, a module with ``read(ctx)`` that returns the
  metric's value, or None where the run gave it nothing to read;
- ``limits/<workload>.json``, the limits of the comparison that decides
  ``correct`` (``check.py``);
- ``kinds/<kind>.py``, named by the traffic file's ``kind``, with
  ``run(spec)``: the set-up, the window and the check of a kind of cell;
- ``reference/<model>.py``, named by the configuration file's ``model``:
  the architecture's plain reference, its flags and its counts
  (``reference/__init__.py``).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def root_dir(package_dir: str = HERE) -> str:
    """The checkout's root: the directory that holds the package and
    ``BENCHMARK.json``."""
    return os.path.dirname(package_dir)


@dataclasses.dataclass
class Manifest:
    data: dict
    package_dir: str = HERE

    @classmethod
    def load(cls, package_dir: str = HERE) -> "Manifest":
        with open(os.path.join(root_dir(package_dir), "BENCHMARK.json")) as f:
            return cls(json.load(f), package_dir)

    def workload(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for entry in self.data["configs"]:
            if entry["name"] == cell["config"]:
                with open(os.path.join(root_dir(self.package_dir), entry["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return self._json("traffic", cell["traffic"])

    def metrics(self, cell: dict, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports:
        those whose ``workloads`` name it, or that have no ``workloads``."""
        return [m for m in self.data[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]

    def _json(self, folder: str, name: str) -> dict:
        with open(os.path.join(self.package_dir, folder, f"{name}.json")) as f:
            return json.load(f)

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = os.path.join(self.package_dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"gpubench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def kind(name: str):
    """``kinds/<name>.py``."""
    if not NAME.match(name) or "." in name:
        raise ValueError(f"bad kind {name!r}")
    return importlib.import_module(f"gpubench.kinds.{name}")


# what every architecture's module provides (``reference/__init__.py``);
# ``conv_flops_padded`` is optional
ARCHITECTURE = ("program_flags", "make_weights", "train_steps", "logit_lengths",
                "logit_frames", "train_flops_valid")


def architecture(config: dict, name: str = "the configuration"):
    """``reference/<config["model"]>.py``; a ValueError that names the
    configuration (``name``, as ``BENCHMARK.json`` does) where the model
    is no such module or the module lacks part of the interface."""
    model = config.get("model")
    if not isinstance(model, str) or not NAME.match(model) or "." in model:
        raise ValueError(f"{name}: bad model {model!r}")
    module_name = f"gpubench.reference.{model}"
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as e:
        if e.name != module_name:
            raise
        raise ValueError(f"{name}: model {model!r} has no reference/{model}.py") from None
    missing = [f for f in ARCHITECTURE if not callable(getattr(module, f, None))]
    if missing:
        raise ValueError(f"{name}: reference/{model}.py lacks {', '.join(missing)}")
    return module
