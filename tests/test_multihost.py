"""Multi-process (multi-host analogue) distributed smoke test.

Launches two subprocesses that bootstrap via
:func:`streamz_tpu.parallel.comm.initialize_distributed`
(``jax.distributed.initialize``), form one global 8-device mesh (4 CPU
devices per process), and run the data-parallel training step with psum
gradient allreduce across the process boundary — the multi-host story of
SURVEY.md §2.3/§5.8 exercised for real, not just compiled.
"""

import subprocess
import sys

import pytest

_WORKER = r'''
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, %(repo)r)
pid = int(sys.argv[1])
port = sys.argv[2]

from streamz_tpu.parallel import comm
comm.initialize_distributed(
    coordinator_address="127.0.0.1:" + port, num_processes=2, process_id=pid
)

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from streamz_tpu.nn.model import SpeakerNet
from streamz_tpu.parallel import data_parallel as dp

devs = jax.devices()
assert len(devs) == 8, f"global mesh expected 8 devices, got {len(devs)}"
mesh = Mesh(np.array(devs), (comm.DATA_AXIS,))

net = SpeakerNet.new(input_size=8, hidden1=16, hidden2=8, output=2, seed=3)
rng = np.random.default_rng(0)
B = 64
x = rng.normal(size=(B, 8)).astype(np.float32)
y = rng.integers(0, 2, size=(B,)).astype(np.int32)
w = np.ones((B,), np.float32)

sh = NamedSharding(mesh, P(comm.DATA_AXIS))
xb = jax.device_put(x, sh); yb = jax.device_put(y, sh); wb = jax.device_put(w, sh)

# The DP step composes with the cross-process psum: over the 2-process
# global mesh it gives the loss and params of the single-device corpus step
# on the same global batch.
from streamz_tpu.nn.train import corpus_step

step = dp.make_dp_train_step(mesh)
params, loss = step(net.params, xb, yb, wb, jnp.int32(2), jnp.float32(0.05))
ref_params, ref_loss = corpus_step(
    net.params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
    jnp.int32(2), 0.05,
)
assert abs(float(loss) - float(ref_loss)) < 1e-5, (float(loss), float(ref_loss))
for k in params:
    a = np.asarray(params[k].addressable_data(0)); b = np.asarray(ref_params[k])
    assert np.abs(a - b).max() < 1e-5, k
if pid == 0:
    print("MULTIHOST_LOSS", float(loss))
'''


@pytest.mark.slow
def test_two_process_dp_step(tmp_path):
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = _WORKER % {"repo": repo}
    port = "12391"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", worker, str(i), port],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
        assert p.returncode == 0, out[-2000:]
    assert any("MULTIHOST_LOSS" in o for o in outs)
    loss_line = next(
        l for o in outs for l in o.splitlines() if l.startswith("MULTIHOST_LOSS")
    )
    loss = float(loss_line.split()[1])
    assert 0.0 < loss < 10.0


_CLI_WORKER = r'''
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
# Keep the discovery loop on the single-device scan here: its per-chunk psums
# are covered by unit tests and the single-host CLI invariance test; over
# gRPC-on-CPU they only add minutes of compile/collective time.
os.environ["STREAMZ_SHARD_DISCOVERY"] = "0"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, %(repo)r)
from streamz_tpu.cli import main
sys.exit(main(%(argv)s))
'''


@pytest.mark.slow
def test_two_process_cli_e2e(tmp_path):
    """The full application run multi-host: two processes (4 virtual CPU
    devices each) form one 8-device mesh via --coordinator/--num-processes/
    --process-id, and the written labels and eval metrics are identical to a
    single-process run."""
    import os
    import shutil

    ref_data = "/root/reference/streamz-rs/examples/training_data"
    if not os.path.isdir(ref_data):
        pytest.skip("reference sample data absent")
    clips = sorted(os.listdir(ref_data))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def stage(root):
        root.mkdir()
        (root / "data").mkdir()
        for c in clips:
            shutil.copy(os.path.join(ref_data, c), root / "data" / c)
        (root / "train_files.txt").write_text(
            "".join(f"data/{c}\n" for c in clips if c.endswith(".mp3"))
        )

    def run(workdir, argv, extra_env=None):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.update(extra_env or {})
        proc = subprocess.Popen(
            [sys.executable, "-c", _CLI_WORKER % {"repo": repo, "argv": repr(argv)}],
            cwd=str(workdir), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        return proc

    # Single-process baseline (8 devices in one process).
    base = tmp_path / "single"
    stage(base)
    p = run(base, [], {"XLA_FLAGS": ""})
    out, _ = p.communicate(timeout=900)
    assert p.returncode == 0, out[-3000:]

    # Two-process run: each process gets its own working dir (per-host
    # filesystems), same file list.
    port = "12417"
    dirs = [tmp_path / "proc0", tmp_path / "proc1"]
    procs = []
    for pid, d in enumerate(dirs):
        stage(d)
        argv = [
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--process-id", str(pid),
        ]
        procs.append(run(d, argv))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out)
        assert p.returncode == 0, out[-3000:]
    assert any("across 2 hosts" in o for o in outs)

    labels_single = (base / "train_files.txt").read_text()
    for d in dirs:
        assert (d / "train_files.txt").read_text() == labels_single

    # Eval: metrics identical single- vs two-process.
    p = run(base, ["--eval"], {"XLA_FLAGS": ""})
    out_eval, _ = p.communicate(timeout=900)
    assert p.returncode == 0, out_eval[-3000:]

    procs = []
    for pid, d in enumerate(dirs):
        argv = [
            "--eval",
            "--coordinator", f"127.0.0.1:{int(port) + 1}",
            "--num-processes", "2", "--process-id", str(pid),
        ]
        procs.append(run(d, argv))
    outs_eval = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs_eval.append(out)
        assert p.returncode == 0, out[-3000:]

    def metrics(text):
        return [
            ln.strip() for ln in text.splitlines()
            if ln.strip().startswith(("Accuracy:", "Precision:", "Recall:", "F1-score:"))
        ]

    assert len(metrics(out_eval)) == 4
    for o in outs_eval:
        assert metrics(o) == metrics(out_eval)


def test_partial_distributed_args_rejected():
    """A bare process_id is a misconfigured launcher, not a single-process
    job — silently skipping initialize would run per-host psums."""
    import pytest

    from streamz_tpu.parallel import comm

    with pytest.raises(ValueError):
        comm.initialize_distributed(process_id=1)
    # ANY partial combination is rejected with the contract's message, not
    # handed to jax half-specified (e.g. --num-processes without
    # --coordinator would otherwise fail with an obscure internal error).
    with pytest.raises(ValueError, match="pass all three"):
        comm.initialize_distributed(num_processes=4)
    with pytest.raises(ValueError, match="pass all three"):
        comm.initialize_distributed(coordinator_address="h:1", process_id=0)
    comm.initialize_distributed()  # all-None: the single-process no-op
