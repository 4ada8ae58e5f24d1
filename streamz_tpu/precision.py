"""The matmul precision of every float32 GEMM the device runs.

XLA's default for a float32 GEMM on the GPU is TF32 (a 10-bit mantissa).
Measured on an H100 80GB HBM3 (power limit 700 W), one card, max abs error
against float64 references, and time; the frontend runs 32 synthetic voices
of 10 s padded to its power-of-two bucket (2048 blocks of 400 samples):

===========  ====================  ===============  ====================
algorithm    MFCC features,        classifier       corpus gradient,
             32 x 10 s voices      softmax, 65,536  max err / max |g|
             (gate 1e-3), ms       windows, ms
===========  ====================  ===============  ====================
TF32         0.23, 0.598           6.6e-3, 0.296    3.4e-2
HIGH         0.23, 0.686           6.6e-3, 0.404    3.4e-2
bf16x3       6.7e-4, 0.839         8.8e-5, 0.392    1.1e-2
bf16x6       5.2e-6, 1.144         1.4e-6, 0.546    8.0e-7
tf32x3       1.0e-5, 1.438         3.0e-6, 0.753    1.5e-6
HIGHEST      6.6e-6, 1.283         6.3e-6, 0.802    2.3e-6
===========  ====================  ===============  ====================

TF32 and ``Precision.HIGH`` fail the frontend's parity gate outright on
speech-like audio with a steep spectral tilt (weak mel bands carry the
large error of the loud ones), and bf16x3 passes it by a third, which is
no margin.  bf16x6 would be the cheapest safe choice, but XLA drops dot
algorithms (bf16x6, float32) from programs partitioned over several GPUs
and runs those GEMMs in TF32: on four H100s the PCM-sharded frontend came
out 0.153 off the golden spec and the data-parallel gradient 2.9e-2 off,
while ``Precision.HIGHEST`` held both (2.8e-6 and 2.1e-6).  So every device
GEMM — frontend, classifier, cosine matches — runs at HIGHEST, true
float32.  An explicit bf16 hi/lo split into plain bf16 dots would keep
bf16x6's speed on every mesh; that is a performance change for later.
On the CPU (the tests) HIGHEST is plain float32.
"""

import jax

MATMUL = jax.lax.Precision.HIGHEST
