"""Single-device (non-federated) CTGAN synthesizer
(counterpart of ``fed_tgan_tpu/train/standalone.py:29-105``, the
reference's standalone ``CTGANSynthesizer.fit/sample``,
Server/dtds/synthesizers/ctgan.py:309-488).

``fit`` runs mixture fit -> encode -> samplers -> init -> epochs, all on
one device; ``sample`` goes through the serving engine's chunked sampler,
and ``to_saved`` gives the artifact that ``serve`` loads.  With
``TrainConfig(precision="bf16")`` the steps and the sampling compute in
bf16 with float32 islands; the weights and Adam moments stay float32.
"""

from __future__ import annotations

import copy
import time
from typing import Optional, Sequence

import numpy as np
import torch

from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.features.transformer import ModeNormalizer
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.runtime.checkpoint import SavedSynthesizer
from fed_tgan_torch.serve.engine import SamplingEngine
from fed_tgan_torch.serve.registry import LoadedModel
from fed_tgan_torch.train.sampler import CondSampler, RowSampler
from fed_tgan_torch.train.steps import (
    Models,
    TrainConfig,
    epoch,
    init_models,
    require_trainable,
)

KEY_OFFSET = 17  # the JAX package's sampling stream offset


class StandaloneSynthesizer:
    """``fit`` on a numeric matrix (categorical columns as integer codes),
    ``sample`` decoded rows.  Runs on ``device``: the card unless the
    caller asks for the CPU.  ``bgm_backend`` picks the mixture fit
    (``"jax"``, the batched fit on ``device``; ``"sklearn"``, the host
    fit)."""

    def __init__(self, config: Optional[TrainConfig] = None, seed: int = 0,
                 device="cuda", bgm_backend: str = "jax"):
        self.cfg = config or TrainConfig()
        self.seed = seed
        self.bgm_backend = bgm_backend
        self.device = resolve_device(device)
        self.transformer: Optional[ModeNormalizer] = None
        self.models: Optional[Models] = None
        self.metrics: dict = {}
        self.timings: dict = {}
        self._engine: Optional[SamplingEngine] = None

    def fit(self, data: np.ndarray, categorical_idx: Sequence[int] = (),
            ordinal_idx: Sequence[int] = (),
            epochs: int = 3) -> "StandaloneSynthesizer":
        """Train for ``epochs`` epochs of ``len(data) // batch_size``
        steps.  ``timings`` gets the mixture fit's seconds and each
        epoch's (both end in a copy to the host, so they are synchronised);
        ``metrics`` the last step's losses."""
        require_trainable(self.cfg)
        steps_per_epoch = len(data) // self.cfg.batch_size
        if steps_per_epoch == 0:
            raise ValueError(f"need at least batch_size={self.cfg.batch_size}"
                             f" rows, got {len(data)}")
        t0 = time.perf_counter()
        self.transformer = ModeNormalizer(
            device=self.device, backend=self.bgm_backend,
            seed=self.seed).fit(data, categorical_idx, ordinal_idx)
        self.timings = {"bgm_fit_s": time.perf_counter() - t0, "epoch_s": []}
        train = self.transformer.transform(
            data, rng=np.random.default_rng(self.seed))
        self.spec = SegmentSpec.from_output_info(self.transformer.output_info)
        self.cond = CondSampler.from_data(train, self.spec, self.device)
        self.rows = RowSampler.from_data(train, self.spec, self.device)
        self.train_data = torch.as_tensor(train, device=self.device)
        self.models = init_models(self.spec, self.cfg, self.seed, self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._engine = None
        for _ in range(epochs):
            t0 = time.perf_counter()
            metrics = epoch(self.models, self.train_data, self.cond,
                            self.rows, gen, steps_per_epoch)
            # read once per epoch, after its steps
            # torchlint: disable=J01
            self.metrics = {k: float(v) for k, v in metrics.items()}
            self.timings["epoch_s"].append(time.perf_counter() - t0)
        return self

    def to_saved(self) -> SavedSynthesizer:
        """The trained model as a sampling artifact: a copy of the
        generator in eval mode, the conditional tables and the decode
        columns."""
        if self.models is None:
            raise RuntimeError("fit first")
        return SavedSynthesizer(copy.deepcopy(self.models.generator),
                                self.cond, self.transformer.columns, self.cfg,
                                key_offset=KEY_OFFSET)

    def sample_encoded(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` activated rows in the encoded layout, rows ``[0, n)`` of
        the sampling stream ``seed``."""
        if self._engine is None:
            self._engine = SamplingEngine(LoadedModel(
                model_id="in-memory", synth=self.to_saved(), meta=None,
                encoders=(), artifact=None))
        return self._engine.sample_encoded(n, seed=seed)

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` decoded rows: numeric column values, categorical columns
        as codes."""
        return self.transformer.inverse_transform(self.sample_encoded(n, seed))
