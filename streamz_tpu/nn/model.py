"""The speaker-ID MLP as a JAX pytree with statically-shaped class growth.

Reference architecture (``streamz-rs/src/lib.rs:744-790``): a 3-layer MLP
``w1`` (in x h1, ReLU) -> ``w2`` (h1 x h2, tanh) -> ``w3`` (h2 x out, softmax),
weights init U(-0.5, 0.5), zero biases, instantiated 60x512x256xS by the CLI
(``src/main.rs:640``).  The reference grows the softmax layer one column at a
time with ``add_output_class`` (``src/lib.rs:797-821``).

Static-shape redesign: XLA requires static shapes, so ``w3``/``b3`` are
pre-allocated at a *capacity* that is a multiple of 128 and a
logical ``num_speakers`` counter masks the inactive columns.  The unexposed
columns are already initialized U(-0.5, 0.5) with zero bias, so revealing the
next column is distributionally identical to the reference's append of a fresh
random column.  Growth past capacity doubles the buffer (an O(log n) number of
recompiles).  Checkpoints emit only the live columns, keeping the ``model.npz``
schema byte-compatible (see :mod:`streamz_tpu.nn.checkpoint`).

Both embedding heads of the reference are reproduced:

- ``embed`` = tanh(h2)  (``src/lib.rs:895-900``)
- ``forward_embedding`` = ReLU(h2) — note the different activation
  (``src/lib.rs:1073-1079``); the train/eval call sites use this one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from streamz_tpu import config
from streamz_tpu.precision import MATMUL

Params = Dict[str, jax.Array]

# Large negative logit used to mask inactive softmax columns. Finite (not
# -inf) so that exp() underflows cleanly to 0.0 without NaN risk.
MASK_LOGIT = -1e30

_CAPACITY_ALIGN = 128


def round_capacity(n: int) -> int:
    """Round a class count up to the 128-aligned capacity."""
    n = max(int(n), 1)
    return ((n + _CAPACITY_ALIGN - 1) // _CAPACITY_ALIGN) * _CAPACITY_ALIGN


def _uniform(rng: np.random.Generator, shape) -> np.ndarray:
    # Reference init: U(-0.5, 0.5) (src/lib.rs:770).
    return rng.uniform(-0.5, 0.5, size=shape).astype(np.float32)


def init_params(
    input_size: int,
    hidden1: int,
    hidden2: int,
    output: int,
    *,
    capacity: Optional[int] = None,
    seed: int = 0,
) -> Params:
    """Create a fresh parameter pytree (src/lib.rs:767-790)."""
    rng = np.random.default_rng(seed)
    cap = round_capacity(capacity if capacity is not None else output)
    return {
        "w1": jnp.asarray(_uniform(rng, (input_size, hidden1))),
        "b1": jnp.zeros((hidden1,), jnp.float32),
        "w2": jnp.asarray(_uniform(rng, (hidden1, hidden2))),
        "b2": jnp.zeros((hidden2,), jnp.float32),
        "w3": jnp.asarray(_uniform(rng, (hidden2, cap))),
        "b3": jnp.zeros((cap,), jnp.float32),
    }


def class_mask(capacity: int, num_speakers) -> jax.Array:
    """[capacity] float mask: 1.0 for live columns, 0.0 for inactive."""
    return (jnp.arange(capacity) < num_speakers).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Pure forward functions (batched; used under jit/vmap everywhere).
# ---------------------------------------------------------------------------


def matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """The classifier's GEMMs, at the explicit precision of
    :mod:`streamz_tpu.precision` (the GPU's default would be TF32)."""
    return jnp.matmul(a, b, precision=MATMUL)


def hidden_tanh(params: Params, x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Shared trunk: returns (h1=relu, h2=tanh). x: [..., in]."""
    h1 = jax.nn.relu(matmul(x, params["w1"]) + params["b1"])
    h2 = jnp.tanh(matmul(h1, params["w2"]) + params["b2"])
    return h1, h2


def forward_logits(params: Params, x: jax.Array, num_speakers) -> jax.Array:
    """Masked logits over the full capacity. x: [..., in] -> [..., capacity]."""
    _, h2 = hidden_tanh(params, x)
    logits = matmul(h2, params["w3"]) + params["b3"]
    mask = jnp.arange(logits.shape[-1]) < num_speakers
    return jnp.where(mask, logits, MASK_LOGIT)


def forward(params: Params, x: jax.Array, num_speakers) -> jax.Array:
    """Softmax probabilities over live classes (src/lib.rs:880-891).

    Returns [..., capacity]; inactive columns are exactly 0.0.  The
    explicit mask also holds the documented invariant when
    ``num_speakers == 0`` (a loadable checkpoint state), where the
    all-``MASK_LOGIT`` softmax would otherwise degenerate to a uniform
    1/capacity row.
    """
    probs = jax.nn.softmax(forward_logits(params, x, num_speakers), axis=-1)
    return probs * class_mask(probs.shape[-1], num_speakers)


def embed(params: Params, x: jax.Array) -> jax.Array:
    """tanh-h2 embedding head (src/lib.rs:895-900)."""
    _, h2 = hidden_tanh(params, x)
    return h2


def forward_embedding(params: Params, x: jax.Array) -> jax.Array:
    """ReLU-h2 embedding head (src/lib.rs:1073-1079).

    This is the variant used by the incremental loop and ``--eval``
    (src/main.rs:575, :765-767).
    """
    h1 = jax.nn.relu(matmul(x, params["w1"]) + params["b1"])
    h2 = jax.nn.relu(matmul(h1, params["w2"]) + params["b2"])
    return h2


def forward_bits(params: Params, x: jax.Array) -> jax.Array:
    """Sigmoid output head used by the steganography codec (src/lib.rs:908-914).

    Unlike :func:`forward`, no class masking is applied — the stego net uses
    its full output layer.
    """
    _, h2 = hidden_tanh(params, x)
    return jax.nn.sigmoid(matmul(h2, params["w3"]) + params["b3"])


# ---------------------------------------------------------------------------
# Host-side wrapper carrying model metadata (mirrors `SimpleNeuralNet`).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpeakerNet:
    """Host-side model object: params + training provenance metadata.

    Mirrors the reference ``SimpleNeuralNet`` struct fields
    (``src/lib.rs:744-762``): per-speaker ``file_lists``, dataset specs,
    stored speaker embeddings ``(mean, mean_sim, std_sim)``, and the optional
    ``w4/b4`` steganography layer.
    """

    params: Params
    num_speakers: int
    file_lists: List[List[str]]
    sample_rate: int = config.DEFAULT_SAMPLE_RATE
    bits: int = 16
    # list of (mean_embedding [h2], mean_sim, std_sim)
    embeddings: List[Tuple[np.ndarray, float, float]] = dataclasses.field(
        default_factory=list
    )
    w4: Optional[np.ndarray] = None
    b4: Optional[np.ndarray] = None
    _growth_seed: int = 1_000_003

    # -- construction -------------------------------------------------------

    @classmethod
    def new(
        cls,
        input_size: int = config.FEATURE_SIZE,
        hidden1: int = config.HIDDEN1,
        hidden2: int = config.HIDDEN2,
        output: int = 1,
        *,
        seed: int = 0,
    ) -> "SpeakerNet":
        params = init_params(input_size, hidden1, hidden2, output, seed=seed)
        return cls(
            params=params,
            num_speakers=output,
            file_lists=[[] for _ in range(output)],
        )

    # -- basic accessors (names follow the reference API) -------------------

    @property
    def capacity(self) -> int:
        return int(self.params["w3"].shape[1])

    def output_size(self) -> int:
        return self.num_speakers

    def embedding_size(self) -> int:
        return int(self.params["w2"].shape[1])

    def input_size(self) -> int:
        return int(self.params["w1"].shape[0])

    def set_dataset_specs(self, sample_rate: int, bits: int) -> None:
        self.sample_rate = sample_rate
        self.bits = bits

    # -- class growth (src/lib.rs:797-821) ----------------------------------

    def add_output_class(self) -> None:
        """Expose one more softmax column, doubling capacity if exhausted."""
        if self.num_speakers >= self.capacity:
            self._grow_capacity(self.capacity * 2)
        if len(self.file_lists) <= self.num_speakers:
            self.file_lists.append([])
        self.num_speakers += 1

    def ensure_capacity(self, n: int) -> None:
        """Grow the padded ``w3`` capacity to hold at least ``n`` classes.

        Used to pre-size the layout before the device-resident incremental
        loop so on-device class growth never needs a recompile."""
        if n > self.capacity:
            self._grow_capacity(n)

    def _grow_capacity(self, new_capacity: int) -> None:
        new_capacity = round_capacity(new_capacity)
        h2 = self.embedding_size()
        old_cap = self.capacity
        rng = np.random.default_rng(self._growth_seed)
        self._growth_seed += 1
        extra_w = _uniform(rng, (h2, new_capacity - old_cap))
        w3 = jnp.concatenate([self.params["w3"], jnp.asarray(extra_w)], axis=1)
        b3 = jnp.concatenate(
            [self.params["b3"], jnp.zeros((new_capacity - old_cap,), jnp.float32)]
        )
        self.params = dict(self.params, w3=w3, b3=b3)

    def set_output_layer(self, w3: np.ndarray, b3: np.ndarray) -> None:
        """Replace the live softmax layer (src/lib.rs:829-833).

        Padding columns are re-drawn U(-0.5, 0.5) — zero-filling them would
        break the module invariant that revealing the next column via
        ``add_output_class`` is distributionally a fresh random init.
        The buffer never SHRINKS below the current capacity: a prior
        ``ensure_capacity`` pre-sized it so on-device class growth needs
        no recompile, and capacity-sized companion state (seed/centroid
        arrays) may already exist at that width."""
        n = int(b3.shape[0])
        cap = round_capacity(max(n, self.capacity))
        rng = np.random.default_rng(self._growth_seed)
        self._growth_seed += 1
        w3_full = _uniform(rng, (w3.shape[0], cap))
        b3_full = np.zeros((cap,), np.float32)
        w3_full[:, :n] = w3
        b3_full[:n] = b3
        self.params = dict(
            self.params, w3=jnp.asarray(w3_full), b3=jnp.asarray(b3_full)
        )
        self.num_speakers = n

    # -- stego layer (src/lib.rs:836-847) ------------------------------------

    def set_encoding_layer(self, w4: np.ndarray, b4: np.ndarray) -> None:
        self.w4 = np.asarray(w4, np.float32)
        self.b4 = np.asarray(b4, np.float32)

    def encoding_layer(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self.w4 is not None and self.b4 is not None:
            return self.w4, self.b4
        return None

    def output_layer(self) -> Tuple[np.ndarray, np.ndarray]:
        """Live (unpadded) softmax layer (src/lib.rs:850-852)."""
        w3 = np.asarray(self.params["w3"])[:, : self.num_speakers]
        b3 = np.asarray(self.params["b3"])[: self.num_speakers]
        return w3, b3

    # -- provenance metadata -------------------------------------------------

    def record_training_file(self, cls_id: int, path: str) -> None:
        """Append a path to a speaker's file list, de-duplicated (src/lib.rs:855-862)."""
        while len(self.file_lists) <= cls_id:
            self.file_lists.append([])
        if path not in self.file_lists[cls_id]:
            self.file_lists[cls_id].append(path)

    def set_embeddings(
        self, embeds: List[Tuple[np.ndarray, float, float]]
    ) -> None:
        self.embeddings = embeds

    # -- convenience host-side forward passes --------------------------------

    def forward(self, x) -> np.ndarray:
        """Softmax over the *live* classes only, shape [..., num_speakers]."""
        out = forward(self.params, jnp.asarray(x, jnp.float32), self.num_speakers)
        return np.asarray(out)[..., : self.num_speakers]

    def embed_np(self, x) -> np.ndarray:
        return np.asarray(embed(self.params, jnp.asarray(x, jnp.float32)))

    # reference method name (src/lib.rs:895-900)
    embed_host = embed_np

    def forward_embedding_np(self, x) -> np.ndarray:
        return np.asarray(forward_embedding(self.params, jnp.asarray(x, jnp.float32)))

    def forward_bits(self, x) -> np.ndarray:
        """Sigmoid head on the live (unmasked) output columns
        (src/lib.rs:908-914).  Sliced to ``num_speakers``: the reference's
        output is exactly the trained bit width, while our w3 buffer is
        capacity-padded with random init columns — returning those would
        hand a consumer deriving payload length from the shape
        ``capacity - n_bits`` phantom bits of garbage."""
        out = np.asarray(forward_bits(self.params, jnp.asarray(x, jnp.float32)))
        return out[..., : self.num_speakers]

    # -- in-place training steps (reference method surface,
    #    src/lib.rs:917-1060) -------------------------------------------------

    def train(self, x, target, lr: float) -> None:
        """Single-sample CE+softmax SGD step (src/lib.rs:954-999)."""
        self.train_batch(np.asarray(x, np.float32)[None, :], target, lr)

    def train_batch(self, batch, target, lr: float) -> None:
        """Mean-gradient SGD over a batch with a shared live-class target
        vector (src/lib.rs:1002-1060)."""
        from streamz_tpu.nn import train as _T

        batch = jnp.asarray(batch, jnp.float32)
        if batch.size == 0:
            return
        t_live = np.asarray(target, np.float32)
        t_full = np.zeros((self.capacity,), np.float32)
        t_full[: min(len(t_live), self.capacity)] = t_live[: self.capacity]
        t = jnp.broadcast_to(jnp.asarray(t_full), (batch.shape[0], self.capacity))
        self.params = _T.train_batch(
            self.params, batch, t, jnp.float32(lr), jnp.int32(self.num_speakers)
        )

    def train_bits(self, x, target, lr: float) -> None:
        """Single-step MSE+sigmoid update on the full output layer
        (src/lib.rs:917-951)."""
        from streamz_tpu.nn import train as _T

        t_live = np.asarray(target, np.float32)
        n_live = min(len(t_live), self.capacity)
        t_full = np.zeros((self.capacity,), np.float32)
        t_full[:n_live] = t_live[: self.capacity]
        self.params = _T.train_bits_step(
            self.params, jnp.asarray(x, jnp.float32), jnp.asarray(t_full),
            jnp.float32(lr), jnp.int32(n_live),
        )

    # -- persistence (src/lib.rs:1081-1281) ----------------------------------

    def save(self, path: str) -> None:
        from streamz_tpu.nn import checkpoint

        checkpoint.save(self, path)

    @classmethod
    def load(cls, path: str) -> "SpeakerNet":
        from streamz_tpu.nn import checkpoint

        return checkpoint.load(path)
