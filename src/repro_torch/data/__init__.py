from repro_torch.data.pipeline import SyntheticTokens, ensemble_token_stream, regression_dataset  # noqa
