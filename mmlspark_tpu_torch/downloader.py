"""Model repository: schemas and a local repo, the offline parts of the
reference's `mmlspark_tpu/downloader.py` (ModelDownloader.scala:27-270:
Repository[S], HDFSRepo, ModelSchema entries consumed by
ImageFeaturizer.setModel).

A repository is a directory of saved variable trees (npz, one key per leaf
path joined by "/") plus a JSON index, in the reference's layout, so a
repo written by either package reads in the other. Tensors are saved as
host arrays; loaded trees hold numpy arrays. The reference's remote
repositories fetch over the network and are not ported.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class ModelSchema:
    """reference: downloader/Schema.scala — name, uri, inputNode, layerNames."""
    name: str
    uri: str = ""
    input_shape: tuple = (224, 224, 3)
    num_classes: int = 1000
    variables: Optional[dict] = None

    def to_json(self) -> dict:
        return {"name": self.name, "uri": self.uri,
                "input_shape": list(self.input_shape),
                "num_classes": self.num_classes}


class Repository:
    def list_models(self) -> list:
        raise NotImplementedError

    def get_model(self, name: str) -> ModelSchema:
        raise NotImplementedError


class LocalRepo(Repository):
    """Directory repo: <root>/index.json + <root>/<name>.npz variable trees."""

    def __init__(self, root: str):
        self.root = root

    def list_models(self) -> list:
        index = os.path.join(self.root, "index.json")
        if not os.path.exists(index):
            return []
        with open(index) as f:
            return [ModelSchema(name=e["name"], uri=e.get("uri", ""),
                                input_shape=tuple(e.get("input_shape",
                                                        (224, 224, 3))),
                                num_classes=e.get("num_classes", 1000))
                    for e in json.load(f)]

    def get_model(self, name: str) -> ModelSchema:
        for schema in self.list_models():
            if schema.name == name:
                path = os.path.join(self.root, f"{name}.npz")
                if os.path.exists(path):
                    schema.variables = load_variables(path)
                return schema
        raise KeyError(f"model {name!r} not in repo {self.root}")

    def put_model(self, schema: ModelSchema):
        os.makedirs(self.root, exist_ok=True)
        entries = [s.to_json() for s in self.list_models()
                   if s.name != schema.name]
        entries.append(schema.to_json())
        with open(os.path.join(self.root, "index.json"), "w") as f:
            json.dump(entries, f, indent=1)
        if schema.variables is not None:
            save_variables(os.path.join(self.root, f"{schema.name}.npz"),
                           schema.variables)


def save_variables(path: str, tree: dict):
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, torch.Tensor):
            flat[prefix] = node.detach().cpu().numpy()
        else:
            flat[prefix] = np.asarray(node)

    walk(tree, "")
    np.savez(path, **flat)


def load_variables(path: str) -> dict:
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            cur = out
            parts = key.split("/")
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = z[key]
    return out
