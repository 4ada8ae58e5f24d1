"""StreamZ: an incremental open-set speaker-ID framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the reference
StreamZ application (Mycoearthdome/StreamZ): audio ingest (MP3/WAV decode,
resample to 44.1 kHz), a batched GEMM MFCC+delta frontend, a batched
speaker-classification MLP with dynamically growing output classes, cosine
centroid identification, k-means clustering, npz checkpoint interop, an
incremental discovery loop, and the steganography subsystem — all designed
SPMD-first for multi-device meshes.

The names exported here mirror the reference crate's ``pub`` surface
(``streamz-rs/src/lib.rs``) one-to-one so users of the reference can map
directly; see PARITY.md for the full component table.
"""

from streamz_tpu.config import (
    CHECKSUM_CONSTANT,
    DEFAULT_DROPOUT,
    DEFAULT_SAMPLE_RATE,
    FEATURE_SIZE,
    MFCC_SIZE,
    WINDOW_SIZE,
    WITH_DELTAS,
    get_checksum_constant,
    set_checksum_constant_override,
    set_wav_cache_enabled,
    wav_cache_enabled,
)
from streamz_tpu.dsp.features import (
    FeatureExtractor,
    load_cached_features,
    save_cached_features,
    with_thread_extractor,
)
from streamz_tpu.dsp.mfcc import DeviceFeatureStore
from streamz_tpu.dsp.resample import resample_to_44100
from streamz_tpu.infer.cluster import cluster_embeddings
from streamz_tpu.infer.cosine import (
    compute_speaker_embeddings,
    cosine_similarity,
    identify_embedding_cosine,
    identify_sims_cosine,
    identify_speaker_cosine,
    identify_speaker_cosine_feats,
    identify_speaker_from_embedding,
)
from streamz_tpu.infer.embed import (
    average_features,
    average_vectors,
    extract_embedding,
    extract_embedding_from_features,
    median_embedding_from_features,
    normalize,
)
from streamz_tpu.infer.identify import (
    identify_speaker,
    identify_speaker_list,
    identify_speaker_list_batch,
    identify_speaker_with_threshold,
    identify_speaker_with_threshold_feats,
)
from streamz_tpu.io.audio import (
    audio_metadata,
    batch_resample,
    downmix_to_mono,
    i16_to_f32,
    load_and_resample_file,
    load_audio_samples,
    load_mp3_samples,
    load_wav_samples,
)
from streamz_tpu.app.corpus import train_corpus
from streamz_tpu.io.g711 import (
    alaw_decode,
    alaw_encode,
    ulaw_decode,
    ulaw_encode,
)
from streamz_tpu.app.serve import MultiStreamIdentifier
from streamz_tpu.app.server import SpeakerServer, StreamClient
from streamz_tpu.app.stream import StreamingIdentifier
from streamz_tpu.nn.drivers import (
    pretrain_from_features,
    pretrain_network,
    train_from_feature_map,
    train_from_files,
)
from streamz_tpu.nn.model import SpeakerNet
from streamz_tpu.nn.train import corpus_step
from streamz_tpu.stego.codec import (
    encode_file,
    extract_file,
    extract_file_from_classifier,
)

# The reference exports `SimpleNeuralNet`; SpeakerNet is its equivalent.
SimpleNeuralNet = SpeakerNet

__version__ = "0.1.0"

__all__ = [
    "CHECKSUM_CONSTANT",
    "DEFAULT_DROPOUT",
    "DEFAULT_SAMPLE_RATE",
    "FEATURE_SIZE",
    "MFCC_SIZE",
    "WINDOW_SIZE",
    "WITH_DELTAS",
    "DeviceFeatureStore",
    "FeatureExtractor",
    "SimpleNeuralNet",
    "SpeakerNet",
    "MultiStreamIdentifier",
    "SpeakerServer",
    "StreamClient",
    "StreamingIdentifier",
    "alaw_decode",
    "alaw_encode",
    "ulaw_decode",
    "ulaw_encode",
    "corpus_step",
    "train_corpus",
    "audio_metadata",
    "average_features",
    "average_vectors",
    "batch_resample",
    "cluster_embeddings",
    "compute_speaker_embeddings",
    "cosine_similarity",
    "downmix_to_mono",
    "encode_file",
    "extract_embedding",
    "extract_embedding_from_features",
    "extract_file",
    "extract_file_from_classifier",
    "get_checksum_constant",
    "i16_to_f32",
    "identify_speaker",
    "identify_embedding_cosine",
    "identify_sims_cosine",
    "identify_speaker_cosine",
    "identify_speaker_cosine_feats",
    "identify_speaker_from_embedding",
    "identify_speaker_list",
    "identify_speaker_list_batch",
    "identify_speaker_with_threshold",
    "identify_speaker_with_threshold_feats",
    "load_and_resample_file",
    "load_audio_samples",
    "load_cached_features",
    "load_mp3_samples",
    "load_wav_samples",
    "median_embedding_from_features",
    "save_cached_features",
    "normalize",
    "pretrain_from_features",
    "pretrain_network",
    "resample_to_44100",
    "set_checksum_constant_override",
    "set_wav_cache_enabled",
    "train_from_feature_map",
    "train_from_files",
    "wav_cache_enabled",
    "with_thread_extractor",
]
