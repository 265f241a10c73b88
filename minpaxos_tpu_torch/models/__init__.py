"""Consensus protocol steps and the pod-mode cluster, batched over replicas."""
