"""TorchServer — serve a TorchScript archive behind the component API.

The port's counterpart of the JAX package's ``TORCH_SERVER``
(reference: servers/sklearnserver/sklearnserver/SKLearnServer.py:15-44
pattern): download a TorchScript archive from ``model_uri`` and serve
``predict``.  The JAX package loads it to the host; here the archive is
loaded with ``map_location=`` this component's device and runs on the
card, unless ``device="cpu"``.  Rows go in as float32 (the archive casts
to its own dtype if it wants another) and come back as float32.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.models.cudaserver import resolve_device
from seldon_core_tpu_torch.runtime.component import MicroserviceError, TPUComponent


class TorchServer(TPUComponent):
    def __init__(
        self,
        model_uri: str = "",
        class_names_list: Optional[List[str]] = None,
        softmax_outputs: bool = False,
        device: str = "cuda",
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        self.model_uri = model_uri
        self._class_names = class_names_list
        self.softmax_outputs = bool(softmax_outputs)
        self.device = resolve_device(device)
        self.module: Optional[torch.jit.ScriptModule] = None

    def load(self) -> None:
        if self.module is not None:
            return
        if not self.model_uri:
            raise MicroserviceError("TorchServer needs a model_uri", status_code=400, reason="MISSING_MODEL_URI")
        from seldon_core_tpu_torch.utils import storage

        path = storage.download(self.model_uri)
        module = torch.jit.load(path, map_location=self.device)
        module.eval()
        self.module = module

    def predict(self, X, names, meta=None):
        if self.module is None:
            self.load()
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(X, dtype=np.float32)).to(self.device)
            out = self.module(x)
            if self.softmax_outputs:
                out = torch.softmax(out.float(), dim=-1)
            return out.float().cpu().numpy()

    def class_names(self):
        return self._class_names or []

    def health_status(self):
        return {"model": "torchscript", "device": str(self.device), "loaded": self.module is not None}
