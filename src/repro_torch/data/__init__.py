from repro_torch.data.pipelines import ClickStream, TokenStream, gnn_dataset

__all__ = ["ClickStream", "TokenStream", "gnn_dataset"]
