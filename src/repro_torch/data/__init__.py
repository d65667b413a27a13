from repro_torch.data.pipeline import DataConfig, sample_batch, stacked_node_batches

__all__ = ["DataConfig", "sample_batch", "stacked_node_batches"]
