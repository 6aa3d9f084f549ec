"""Two-process distributed worker (spawned by test_distributed.py).

Each process owns 2 virtual CPU devices; the pair forms a 4-way
spatial mesh across the process boundary (Gloo).  Exercises the framework's own
multi-process entry points: parallel.mesh.init_distributed +
sharded_decompose / sharded_wow, asserting the gathered results match
the single-device reference bitwise (decompose) / exactly (wow, same
reduction order).

Usage: python tests/_dist_worker.py <process_id> <coordinator_port>
(XLA_FLAGS must force 2 host-platform devices; cwd = repo root.)
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1])
port = sys.argv[2]

sys.path.insert(0, ".")

from wavelets_tpu.parallel.mesh import init_distributed, make_mesh  # noqa: E402

init_distributed(coordinator_address=f"127.0.0.1:{port}",
                 num_processes=2, process_id=pid)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

from wavelets_tpu.core.transform import decompose  # noqa: E402
from wavelets_tpu.models.wow import wow_core  # noqa: E402
from wavelets_tpu.ops.filters import B3SPLINE  # noqa: E402
from wavelets_tpu.parallel.sharded import (  # noqa: E402
    sharded_decompose,
    sharded_wow,
)

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()

mesh = make_mesh(rows=2, cols=2)
rng = np.random.default_rng(7)
img = jnp.asarray(rng.normal(size=(128, 128)).astype(np.float32))

# decompose: bitwise vs single device
got = sharded_decompose(img, 3, B3SPLINE, mesh)
got_g = np.asarray(multihost_utils.process_allgather(got, tiled=True))
ref = np.asarray(decompose(img, 3, B3SPLINE))
assert got_g.shape == ref.shape, (got_g.shape, ref.shape)
assert np.array_equal(got_g, ref), np.abs(got_g - ref).max()
print(f"proc {pid}: sharded_decompose bitwise OK", flush=True)

# wow with denoise (exact distributed median + collective std)
recon, planes = sharded_wow(img, mesh, denoise_coefficients=[5.0, 2.0],
                            n_scales=3)
recon_g = np.asarray(
    multihost_utils.process_allgather(recon, tiled=True))
ref_r, _ = wow_core(
    img, jnp.zeros((), jnp.float32), sf=B3SPLINE, n_scales=3,
    weights=(1.0,) * 4, whitening=True,
    denoise_coefficients=(5.0, 2.0, 0.0, 1.0), bilateral=None,
    bilateral_scaling=False, soft_threshold=True,
    preserve_variance=False, gamma=3.2, gamma_min=None, gamma_max=None,
    h=0.0, has_noise=False)
err = float(np.abs(recon_g - np.asarray(ref_r)).max())
scale = float(np.abs(np.asarray(ref_r)).max())
assert err <= 1e-5 * max(scale, 1.0), err
print(f"proc {pid}: sharded_wow OK (err {err:.2e})", flush=True)
print(f"proc {pid}: DIST-OK", flush=True)
