"""Layers of the port: the `Layer` base and containers (`layers`), and
`common`, `activation`, `conv`, `pooling`, `loss`, `norm`, `rnn`,
`transformer` (the ports of the reference's same-named modules)."""
