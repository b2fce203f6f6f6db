"""Multi-request dispatch: the batched-PBS dispatcher."""
