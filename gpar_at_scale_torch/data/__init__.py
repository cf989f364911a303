from gpar_at_scale_torch.data.chain import make_chain_data

__all__ = ["make_chain_data"]
