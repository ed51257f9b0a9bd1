from gcpnet_torch.config.schema import LayerCfg, MPCfg, ModelCfg, ModuleCfg

__all__ = ["LayerCfg", "MPCfg", "ModelCfg", "ModuleCfg"]
