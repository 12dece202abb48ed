from ekaid_torch.models.ekaid import EkaidModel

__all__ = ["EkaidModel"]
