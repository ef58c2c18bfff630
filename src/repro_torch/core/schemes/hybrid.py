"""Hybrid FL/SL participation behind the unified Scheme API.

Reference: src/repro/core/schemes/hybrid.py (`fl_clients`, `cut_mask`,
`_and_mask`, `HybridScheme`: `init`, `_loss`, `_make_step`, `make_round`,
`make_transport_round`, `_predict`, `predict`, `predict_batched`,
`predict_under_faults`, `_weight_charges`, `edge_ledger`,
`bits_per_round`, `wire_bytes_per_round`).

Each client picks HOW it participates (cfg.hybrid_fl_clients): CUT-mode
clients run the SL-style boundary (deterministic cut-layer activations to
the fusion center, eq.-(10) error chunks back) while WEIGHT-mode clients
train their full local model (client-side encoder + own branch head) and
sync fp32 weights with the server each round, FL-style.

Training: every view is encoded and cut, the CUT latents partial-fuse into
the eq.-(5) joint decoder (the static mode mask takes the weight-mode
clients out of every fusion, so the joint latent is scaled by J / n_cut
even on a clean round), and all J branch heads train on their LOCAL latent
u; the loss is the joint cross-entropy plus the mean of the J branch
cross-entropies.  Inference ensembles the joint decoder (one vote per
fused cut latent) with the weight-mode clients' branch predictions (one
vote each) in probability space.

The mode split rides in the state (`state["modes"]`, a (J,) bool tensor,
True where the client ships activations), so inference without a cfg
fuses exactly the latents training fused.

Faults: a dead route drops a cut client's latent from the fusion and costs
a weight client its whole round: its encoder and branch-head rows revert
to the previous state's (the FL skip).  A clean round has nothing to
revert (the reference's all-ones delivery reverts no row), so it skips
the revert.  Bandwidth decomposes per edge: the cut payload's activation
exchange plus 2 x 32 x N_client-side for every weight-mode client the edge
serves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import (as_generator, as_input, optim, resolve_device,
                         tree_map, value_and_grad)
from repro_torch.core import linkfault, losses, paper_model
from repro_torch.core import schemes as _schemes
from repro_torch.core import topology as topology_lib
from repro_torch.core import wirefmt
from repro_torch.core.schemes import base, splitfed


def fl_clients(cfg):
    """Validated, sorted weight-mode client indices from
    cfg.hybrid_fl_clients.  At least one client must stay cut-mode (the
    fusion center needs something to fuse)."""
    J = cfg.num_clients
    idx = tuple(sorted({int(j) for j in
                        (getattr(cfg, "hybrid_fl_clients", ()) or ())}))
    bad = [j for j in idx if not 0 <= j < J]
    if bad:
        raise ValueError(f"hybrid_fl_clients {bad} out of range for "
                         f"num_clients={J}")
    if len(idx) >= J:
        raise ValueError(
            f"hybrid needs at least one cut-mode client: hybrid_fl_clients="
            f"{idx} claims all {J} clients for weight-mode participation")
    return idx


def cut_mask(cfg) -> np.ndarray:
    """(J,) bool, True where the client ships cut-layer activations."""
    w = set(fl_clients(cfg))
    return np.array([j not in w for j in range(cfg.num_clients)], bool)


def _and_mask(static, delivery):
    """static (J,) bool tensor & delivery (J,) or (J, B) (a host mask or a
    tensor), broadcasting the static mode mask over the sample axis when
    needed; the result lies on static's device."""
    if delivery is None:
        return static
    delivery = linkfault.mask_tensor(delivery, static.device)
    s = static if delivery.dim() == 1 else static[:, None]
    return torch.logical_and(s, delivery)


@_schemes.register
class HybridScheme(base.Scheme):
    name = "hybrid"

    def init(self, cfg, generator, *, lr: float = 2e-3, device=None):
        device = resolve_device(device)
        modes = cut_mask(cfg)
        params, state = splitfed.init_clients_and_decoder(
            cfg, as_generator(generator, device), device=device)
        return {"params": params, "state": state,
                "opt": optim.adam(lr).init(params),
                "modes": torch.as_tensor(modes, device=device)}

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _loss(self, params, enc_state, modes, views, labels, cfg, *, wire,
              topo, delivery, drop_masks):
        """Joint cross-entropy on the fused cut latents plus the mean of
        the J branch heads' on their local latents.  Returns (loss,
        (metrics, new encoder state, detached))."""
        dt = paper_model.compute_dtype(cfg)
        params_c = paper_model.cast_compute(params, dt)
        (mu, logvar), new_enc = paper_model.stacked_encoder_apply(
            params_c["encoders"], enc_state["encoders"], views.to(dt),
            train=True)
        u, u_joint = splitfed.cut_latents(cfg, mu, logvar, wire=wire,
                                          topo=topo)
        u_joint = linkfault.partial_fuse(u_joint, _and_mask(modes, delivery))
        logits = paper_model.decoder_apply(
            params_c["decoder"], paper_model.concat_latents(u_joint),
            train=True, drop_masks=drop_masks)
        joint_loss = losses.xent(logits, labels)
        branch = paper_model.branch_heads_apply(params_c["decoder"], u)
        branch_loss = torch.mean(torch.stack(
            [losses.xent(b, labels) for b in branch]))
        loss = joint_loss + branch_loss
        metrics = {"loss": loss, "accuracy": losses.accuracy(logits, labels),
                   "branch_loss": branch_loss}
        return loss, (metrics, tree_map(torch.Tensor.detach,
                                        {"encoders": new_enc}))

    def _make_step(self, cfg, *, lr, wire, topology):
        """step(state, views, labels, generator, delivery, drop_masks):
        views (J, B, ...), labels (B,), delivery a (J,) bool mask (a host
        array or a device tensor) or None (the clean round)."""
        fl_clients(cfg)                      # validate the mode split early
        opt = optim.adam(lr)
        topo = topology_lib.nontrivial(topology, cfg)
        topology_lib.check_wires(topo, cfg, wire)

        def step(state, views, labels, generator, delivery, drop_masks):
            modes = state["modes"]
            if drop_masks is None:
                drop_masks = paper_model.decoder_dropout_masks(
                    generator, cfg.dense_units, labels.shape[0],
                    device=labels.device)
            _, (metrics, new_enc), grads = value_and_grad(
                self._loss, state["params"], state["state"], modes, views,
                labels, cfg, wire=wire, topo=topo, delivery=delivery,
                drop_masks=drop_masks)
            params, opt_state = opt.update(grads, state["opt"],
                                           state["params"])
            if delivery is not None:
                # FL skip semantics: a weight-mode client whose route died
                # never reached the server; its per-client rows (encoder +
                # branch head) revert to the stale server copy.  Cut
                # clients keep their local updates.
                revert = torch.logical_and(
                    ~modes, ~linkfault.mask_tensor(delivery, modes.device))

                def keep(new, old):
                    m = revert.reshape((revert.shape[0],)
                                       + (1,) * (new.dim() - 1))
                    return torch.where(m, old, new)

                old = state["params"]
                params = dict(params, encoders=tree_map(
                    keep, params["encoders"], old["encoders"]))
                params["decoder"] = dict(
                    params["decoder"], branch_heads=tree_map(
                        keep, params["decoder"]["branch_heads"],
                        old["decoder"]["branch_heads"]))
            metrics = {k: v.detach() for k, v in metrics.items()}
            return ({"params": params, "state": new_enc, "opt": opt_state,
                     "modes": modes}, metrics)
        return step

    def make_round_parts(self, cfg, *, lr: float = 2e-3,
                         wire: str = "dense", topology=None):
        """The round (views (1, J, B, ...), labels (1, B)): over unreliable
        links its (J,) delivery mask is drawn on the host from
        `round_key`."""
        step = self._make_step(cfg, lr=lr, wire=wire, topology=topology)
        return splitfed.fault_drawing_parts(self.name, cfg, topology, step)

    def make_transport_round_parts(self, cfg, *, lr: float = 2e-3,
                                   wire: str = "dense", topology=None):
        _, step = self.make_round_parts(cfg, lr=lr, wire=wire,
                                        topology=topology)
        return base.RoundParts(base.transport_plan, step)

    # ------------------------------------------------------------------
    # inference: joint decoder over fused cut latents, ensembled with the
    # weight-mode clients' local branch predictions
    # ------------------------------------------------------------------

    def _predict(self, state, views, topology, cfg, delivery=None,
                 wire: str = "dense", device=None):
        views = as_input(state["params"], views, device)
        modes = state["modes"]
        topo = None if cfg is None else topology_lib.nontrivial(topology,
                                                                cfg)
        with torch.no_grad():
            u, u_joint = splitfed.predict_latents(
                state["params"], state["state"], views, cfg, topo, wire)
            cut_m = _and_mask(modes, delivery)
            w_m = _and_mask(~modes, delivery)
            dec = state["params"]["decoder"]
            u_f = linkfault.partial_fuse(u_joint, cut_m)
            p_dec = torch.softmax(paper_model.decoder_apply(
                dec, paper_model.concat_latents(u_f), train=False), dim=-1)
            p_branch = torch.softmax(paper_model.branch_heads_apply(dec, u),
                                     dim=-1)                  # (J, B, C)
            J, B = modes.shape[0], views.shape[1]
            cut2 = (cut_m if cut_m.dim() == 2 else cut_m[:, None]).to(
                torch.float32).expand(J, B)
            w2 = (w_m if w_m.dim() == 2 else w_m[:, None]).to(
                torch.float32).expand(J, B)
            cut_votes = torch.sum(cut2, dim=0)                  # (B,)
            w_votes = torch.sum(w2, dim=0)
            numer = p_dec * cut_votes[:, None] \
                + torch.sum(p_branch * w2[:, :, None], dim=0)
            total = cut_votes + w_votes
            probs = numer / torch.clamp(total, min=1.0)[:, None]
            uniform = torch.full_like(probs, 1.0 / probs.shape[-1])
            return torch.where(total[:, None] > 0, probs, uniform)

    def predict(self, state, views, topology=None, cfg=None, *,
                device=None):
        return self._predict(state, views, topology, cfg, device=device)

    def predict_batched(self, state, views, *, delivery=None, topology=None,
                        cfg=None, wire: str = "dense", device=None):
        return self._predict(state, views, topology, cfg, delivery=delivery,
                             wire=wire, device=device)

    def predict_under_faults(self, state, views, key, topology=None,
                             cfg=None, *, device=None):
        # per-sample route survival: a dead cut route loses one fusion
        # vote, a dead weight route that client's ensemble vote
        topo_full = topology_lib.resolve(topology, cfg)
        delivery = linkfault.sample_delivery_mask(key, topo_full, cfg,
                                                  views.shape[1])
        return self._predict(state, views, topology, cfg, delivery=delivery,
                             device=device)

    # ------------------------------------------------------------------
    # bandwidth
    # ------------------------------------------------------------------

    def _weight_charges(self, cfg, state):
        """(closed bits, measured bytes) per weight-mode client and
        direction: client-side encoder + its branch head, fp32."""
        J = cfg.num_clients
        n_cs = paper_model.encoder_param_count(splitfed.client_cfg(cfg)) \
            + cfg.d_bottleneck * cfg.num_classes + cfg.num_classes
        nbytes = (base.tree_nbytes(state["params"]["encoders"])
                  + base.tree_nbytes(
                      state["params"]["decoder"]["branch_heads"])) / J
        return 32.0 * n_cs, nbytes

    def edge_ledger(self, cfg, state, batch_size: int, *,
                    wire: str = "dense", topology=None):
        topo = topology_lib.resolve(topology, cfg)
        wset = set(fl_clients(cfg))
        w_bits, w_nbytes = self._weight_charges(cfg, state)
        out = {}
        for e in topo.topo_edges():
            pay = topo.payload(e)
            n_cut = sum(1 for j in pay if j not in wset)
            n_w = len(pay) - n_cut
            q = topology_lib.edge_bits(e, cfg)
            bits = 2.0 * batch_size * n_cut * cfg.d_bottleneck * q
            nbytes = 0.0 if n_cut == 0 else float(wirefmt.round_wire_bytes(
                batch_size * n_cut, cfg.d_bottleneck, link_bits=q,
                wire=topology_lib.edge_wire(e, wire),
                dtype=topology_lib.edge_dtype(e, cfg))["total"])
            out[e.key] = (bits + 2.0 * n_w * w_bits,
                          nbytes + 2.0 * n_w * w_nbytes)
        return out

    def bits_per_round(self, cfg, state, batch_size: int, *,
                       topology=None) -> float:
        return float(sum(b for b, _ in self.edge_ledger(
            cfg, state, batch_size, topology=topology).values()))

    def wire_bytes_per_round(self, cfg, state, batch_size: int, *,
                             wire: str = "dense", topology=None) -> float:
        return float(sum(n for _, n in self.edge_ledger(
            cfg, state, batch_size, wire=wire, topology=topology).values()))
