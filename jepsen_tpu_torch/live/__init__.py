"""The live harness's regression net: the corpus of banked histories
(:mod:`.corpus`) and its replay through every engine route.  The
counterpart of the JAX package's ``jepsen_tpu.live``, so far its
corpus only."""

from .corpus import (attach_minimal, bank, bank_cell,  # noqa: F401
                     corpus_dir, corpus_replay, entries_from_test,
                     entry_model, load_pool, replay_queue)
