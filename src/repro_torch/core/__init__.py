"""pFedWN algorithms (EM weights, Eq-1 aggregation, channel-aware selection)
and the fused federated simulator."""
