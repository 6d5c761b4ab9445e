from .checkpointing import (CheckpointPolicy, RNGStatesTracker, checkpoint,
                            checkpoint_wrapper, configure, get_policy,
                            get_rng_tracker, is_configured,
                            model_parallel_rng_seed, non_reentrant_checkpoint,
                            reset)
