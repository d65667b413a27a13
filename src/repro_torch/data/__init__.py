from repro_torch.data.pipeline import DataConfig, iterate, sample_batch, stacked_node_batches

__all__ = ["DataConfig", "iterate", "sample_batch", "stacked_node_batches"]
