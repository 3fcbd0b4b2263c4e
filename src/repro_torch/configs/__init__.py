"""Client-model and protocol configurations (copies of the JAX
package's `configs/paper_models.py`)."""
