"""Shared target-list utilities (reference: Target struct, worker.h:32-61)."""

from __future__ import annotations

import numpy as np


def targets_to_list(targets):
    """Targets pytree -> list of dicts for host-side consumers (UI, fusion,
    MQTT adapters).

    Device-resident fields are stacked ON DEVICE and fetched in ONE
    transfer: every device->host fetch is a synchronizing round trip, and a
    per-field-per-target ``np.asarray`` loop would make the fusion pass
    fetch-bound.
    """
    import jax

    if isinstance(targets.valid, jax.Array):
        import jax.numpy as jnp

        data = np.asarray(jnp.stack([
            targets.theta, targets.phi, targets.power,
            targets.probability, targets.start,
            targets.valid.astype(jnp.float32),
        ]))
        theta, phi, power, prob, start = data[:5]
        valid = data[5] > 0.5
    else:
        theta = np.asarray(targets.theta)
        phi = np.asarray(targets.phi)
        power = np.asarray(targets.power)
        prob = np.asarray(targets.probability)
        start = np.asarray(targets.start)
        valid = np.asarray(targets.valid)
    out = []
    for i in np.where(valid)[0]:
        out.append(
            {
                "theta": float(theta[i]),
                "phi": float(phi[i]),
                "power": float(power[i]),
                "probability": float(prob[i]),
                "start": float(start[i]),
            }
        )
    return out
