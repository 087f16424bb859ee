"""Model twins: the paper's three models and the LM zoo's split decoder."""
