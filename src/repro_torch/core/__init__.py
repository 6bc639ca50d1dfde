"""The sync DeFTA engine: tasks, topology, gossip transport, trust and
the round program."""
