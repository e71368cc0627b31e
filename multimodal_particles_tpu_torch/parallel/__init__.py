"""Generation at scale: the bulk sampling sweep (`bulk_sampling.py`)."""
