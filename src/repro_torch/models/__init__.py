"""Model twins (the paper's FEMNIST CNN so far)."""
