"""The Paddle 2.0 core of the port: dtypes (`dtype`), seeded generators
(`rng`), tensor creation and parameters (`tensor`), `ParamAttr`
(`param_attr`), unique names (`unique_name`) and the execution mode
(`mode`). The tensor is `torch.Tensor` itself."""
