"""Shared recsys field-vocabulary profiles (``repro.configs.recsys_common``).

``CRITEO39`` sums to 16,596,850 rows (the JAX module's comment says
"~20.6M"; the sum is what the tables hold).
"""

# 39-field Criteo-style profile (AutoInt / xDeepFM): 3 huge id fields, a
# power-law tail, 13 bucketized numeric fields.
CRITEO39 = (
    (10_000_000, 4_000_000, 1_000_000)
    + (500_000,) * 2
    + (100_000,) * 5
    + (10_000,) * 8
    + (2_000,) * 8
    + (100,) * 8
    + (10,) * 5
)
assert len(CRITEO39) == 39

# Amazon-style behaviour profile (DIN / DIEN): user-context fields; the
# item table (1M items) is separate and feeds the behaviour sequence.
AMAZON_CTX = (1_000_000, 100_000, 10_000, 1_000, 100, 10)
ITEM_VOCAB = 1_000_000

# Reduced vocabularies for smoke tests.
SMOKE_39 = tuple([97, 53, 31] + [17] * 36)
SMOKE_CTX = (50, 30, 20)
SMOKE_ITEMS = 200
