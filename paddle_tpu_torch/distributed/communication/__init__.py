"""The collective API over ``torch.distributed`` process groups."""
