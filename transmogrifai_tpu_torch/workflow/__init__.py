"""DAG assembly, the workflow model and its persistence."""
