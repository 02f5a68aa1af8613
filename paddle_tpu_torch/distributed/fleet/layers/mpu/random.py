"""The model-parallel random stream. Counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/random.py``: a re-export of
``core.rng``'s tracker. ``fleet.init`` with a model degree over
processes registers ``MODEL_PARALLEL_RNG`` at seed + 1024 + the mp rank,
so a draw from the global key stream inside
``get_rng_state_tracker().rng_state()`` differs between the mp ranks
(dropout over a rank's own heads) and repeats across the dp ranks. The
port's dropouts draw from explicit generators (``nn.functional.common``)
and LLaMA's model-parallel region has none, so no caller of the port's
mp layers enters the tracker yet."""
from .....core.rng import (MODEL_PARALLEL_RNG, RNGStatesTracker,
                          get_rng_state_tracker, model_parallel_random_seed)

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "MODEL_PARALLEL_RNG"]
