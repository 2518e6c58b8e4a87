"""The port's architecture configs beside the JAX package's.  A port tower
carries its MLP's width (``mlp_width``) and activation (``hidden_act``);
a JAX tower carries the MLP's ratio to the width (``mlp_ratio``) and runs
QuickGELU alone.  Each helper maps one onto the other, field for field."""

import dataclasses

from mcm_tpu_torch import config as tconfig


def port_tower(jtower):
    """The port's ``VisionConfig``/``TextConfig`` of a JAX tower config."""
    fields = dict(vars(jtower))
    ratio = fields.pop("mlp_ratio")
    cls = (tconfig.VisionConfig if hasattr(jtower, "patch_size")
           else tconfig.TextConfig)
    return cls(**fields, mlp_width=ratio * fields["width"])


def port_config(jcfg):
    """The port's ``CLIPConfig`` of a JAX one."""
    return tconfig.CLIPConfig(name=jcfg.name, vision=port_tower(jcfg.vision),
                              text=port_tower(jcfg.text))


def jax_tower(ttower):
    """The JAX package's tower config of a port tower (QuickGELU, an MLP a
    whole multiple of the width)."""
    from mcm_tpu import config as jconfig
    fields = dict(vars(ttower))
    width, act = fields.pop("mlp_width"), fields.pop("hidden_act")
    assert act == "quick_gelu" and width % fields["width"] == 0, (act, width)
    cls = (jconfig.VisionConfig if hasattr(ttower, "patch_size")
           else jconfig.TextConfig)
    return cls(**fields, mlp_ratio=width // fields["width"])


def jax_config(tcfg):
    """The JAX package's ``CLIPConfig`` of a port one."""
    from mcm_tpu import config as jconfig
    return jconfig.CLIPConfig(name=tcfg.name, vision=jax_tower(tcfg.vision),
                              text=jax_tower(tcfg.text))


def jax_fields(tower):
    """A tower config's fields as the JAX package states them."""
    fields = dataclasses.asdict(tower)
    if "mlp_width" in fields:
        width, act = fields.pop("mlp_width"), fields.pop("hidden_act")
        assert act == "quick_gelu" and width % fields["width"] == 0
        fields["mlp_ratio"] = width // fields["width"]
    return fields
