"""Admission validation: the CEL-rule analog of the reference's CRD schemas.

The reference's user API is guarded by OpenAPI + CEL rules embedded in the
CRDs (pkg/apis/crds/karpenter.sh_nodepools.yaml,
karpenter.k8s.aws_ec2nodeclasses.yaml, 1,656 yaml lines; enforced by the
kube-apiserver). This module enforces the same rules — with
reference-shaped messages — at the fake API server's create/update
boundary, so malformed objects are rejected exactly where a real cluster
would reject them.

Covered rules (file:line cites into the reference CRDs):
- NodePool template requirements: restricted label domains
  (karpenter.sh_nodepools.yaml:271-283), minValues bounds and
  values-count floor (:284-330), In needs values, Gt/Lt single
  non-negative integer (:325-328);
- NodePool template labels: restricted domains (:198-210);
- disruption budgets: schedule must be set with duration (:139-141);
- nodeClassRef: group/kind/name non-empty (:234-248), group/kind
  immutable on update (:254-258);
- EC2NodeClass selector terms: list non-empty, per-term "at least one
  of", id/alias mutual exclusivity, alias format + supported families,
  empty tag keys/values (karpenter.k8s.aws_ec2nodeclasses.yaml:94-136,
  :493-533);
- blockDeviceMappings: at most one rootVolume (:237);
- kubelet: eviction signal keys, kubeReserved/systemReserved keys,
  imageGC threshold ordering, evictionSoft <-> grace matching (:285-374);
- restricted tags (apis/v1/labels.go:74-77).
"""

from __future__ import annotations

import re
from typing import Optional

from . import labels as L
from .requirements import Requirements

MIN_VALUES_MIN, MIN_VALUES_MAX = 1, 50

_KUBERNETES_IO_ALLOWED = {
    "beta.kubernetes.io/instance-type",
    "failure-domain.beta.kubernetes.io/region",
    "beta.kubernetes.io/os", "beta.kubernetes.io/arch",
    "failure-domain.beta.kubernetes.io/zone",
    "topology.kubernetes.io/zone", "topology.kubernetes.io/region",
    "node.kubernetes.io/instance-type",
    "kubernetes.io/arch", "kubernetes.io/os",
    "node.kubernetes.io/windows-build",
}
_KARPENTER_SH_ALLOWED = {L.CAPACITY_TYPE, L.NODEPOOL}

_EVICTION_SIGNALS = {"memory.available", "nodefs.available",
                     "nodefs.inodesFree", "imagefs.available",
                     "imagefs.inodesFree", "pid.available"}
_RESERVED_KEYS = {"cpu", "memory", "ephemeral-storage", "pid"}

_AMI_FAMILIES = ("al2", "al2023", "bottlerocket", "windows2019",
                 "windows2022")
_ALIAS_RE = re.compile(r"^[a-z0-9]+@[A-Za-z0-9.v-]+$")
#: ^((100|[0-9]{1,2})%|[0-9]+)$ — karpenter.sh_nodepools.yaml:111
_BUDGET_NODES_RE = re.compile(r"^((100|[0-9]{1,2})%|[0-9]+)$")


class ValidationError(ValueError):
    """Admission rejection — message mirrors the CRD CEL message."""


def _domain(key: str) -> str:
    return key.split("/")[0] if "/" in key else ""


def _dom_is(dom: str, suffix: str) -> bool:
    """Dot-anchored domain match: `dom` IS `suffix` or a subdomain of it
    (plain endswith would let foonode.kubernetes.io impersonate
    node.kubernetes.io — labels.py is_restricted_tag anchors the same way)."""
    return dom == suffix or dom.endswith("." + suffix)


def _check_restricted_label(key: str,
                            allow_nodepool: bool = False) -> Optional[str]:
    """Returns the reference-shaped message, or None if allowed.

    `allow_nodepool`: the NodeClaim CRD allowlists karpenter.sh/nodepool
    in requirements (karpenter.sh_nodeclaims.yaml:133) — the controller
    stamps it — while NodePool templates restrict it (:278-279)."""
    dom = _domain(key)
    if key == L.NODEPOOL and not allow_nodepool:
        return 'label "karpenter.sh/nodepool" is restricted'
    if key == L.HOSTNAME:
        return 'label "kubernetes.io/hostname" is restricted'
    if _dom_is(dom, "kubernetes.io"):
        if key in _KUBERNETES_IO_ALLOWED \
                or _dom_is(dom, "node.kubernetes.io") \
                or _dom_is(dom, "node-restriction.kubernetes.io"):
            return None
        return 'label domain "kubernetes.io" is restricted'
    if _dom_is(dom, "k8s.io") and not _dom_is(dom, "kops.k8s.io"):
        return 'label domain "k8s.io" is restricted'
    if _dom_is(dom, "karpenter.sh") and key not in _KARPENTER_SH_ALLOWED:
        return 'label domain "karpenter.sh" is restricted'
    if _dom_is(dom, "karpenter.k8s.aws") \
            and key not in L.AWS_REQUIREMENT_LABELS:
        return 'label domain "karpenter.k8s.aws" is restricted'
    return None


def _validate_requirements(reqs: Requirements,
                           allow_nodepool: bool = False) -> None:
    for r in reqs:
        msg = _check_restricted_label(r.key, allow_nodepool)
        if msg is not None:
            raise ValidationError(msg)
        if r.min_values is not None:
            if not (MIN_VALUES_MIN <= r.min_values <= MIN_VALUES_MAX):
                raise ValidationError(
                    f"minValues must be in [{MIN_VALUES_MIN}, "
                    f"{MIN_VALUES_MAX}], got {r.min_values}")
            # the CEL floor rule applies to In requirements
            # (karpenter.sh_nodepools.yaml:327-328)
            if not r.complement and r.greater_than is None \
                    and r.less_than is None \
                    and len(r.values) < r.min_values:
                raise ValidationError(
                    "requirements with 'minValues' must have at least that "
                    "many values specified in the 'values' field")
        if (r.greater_than is not None and r.greater_than < 0) \
                or (r.less_than is not None and r.less_than < 0):
            raise ValidationError(
                "requirements operator 'Gt' or 'Lt' must have a single "
                "positive integer value")
        if not r.complement and not r.values \
                and r.greater_than is None and r.less_than is None \
                and not r.impossible:
            # a plain In with zero values could never be satisfied; the CRD
            # rejects it at admission (yaml:325-326). (DoesNotExist compiles
            # to complement with empty values — allowed.)
            raise ValidationError(
                "requirements with operator 'In' must have a value defined")


def validate_nodepool(np) -> None:
    t = np.template
    _validate_requirements(t.requirements)
    for key in t.labels:
        msg = _check_restricted_label(key)
        if msg is not None:
            raise ValidationError(msg)
    ref = t.node_class_ref
    if not ref.name:
        raise ValidationError("name may not be empty")
    if not ref.kind:
        raise ValidationError("kind may not be empty")
    if not ref.group:
        raise ValidationError("group may not be empty")
    for b in np.disruption.budgets:
        if (b.schedule is None) != (b.duration is None):
            raise ValidationError("'schedule' must be set with 'duration'")
        if not _BUDGET_NODES_RE.match(b.nodes.strip()):
            raise ValidationError(f"invalid budget nodes value {b.nodes!r}")
        if b.schedule is not None:
            from ..utils.cron import Cron, CronError, parse_duration
            try:
                Cron(b.schedule)
                parse_duration(b.duration)
            except CronError as e:
                raise ValidationError(f"invalid budget schedule: {e}")


def validate_nodeclaim(nc) -> None:
    _validate_requirements(nc.requirements, allow_nodepool=True)
    if not nc.node_class_ref.name:
        raise ValidationError("name may not be empty")


def _validate_terms(terms, what: str, allow_name: bool = True,
                    allow_alias: bool = False) -> None:
    if not terms:
        raise ValidationError(f"{what} cannot be empty")
    fields = ["tags", "id"] + (["name"] if allow_name else []) \
        + (["alias"] if allow_alias else [])
    n_alias = sum(1 for t in terms if getattr(t, "alias", ""))
    for t in terms:
        present = [f for f in fields if getattr(t, f, None)]
        if not present:
            raise ValidationError(
                f"expected at least one, got none, {fields!r}")
        if t.id and len(present) > 1:
            raise ValidationError(
                f"'id' is mutually exclusive, cannot be set with a "
                f"combination of other fields in {what}")
        alias = getattr(t, "alias", "")
        if alias:
            if len(present) > 1:
                raise ValidationError(
                    "'alias' is mutually exclusive, cannot be set with a "
                    f"combination of other fields in {what}")
            if n_alias and len(terms) > 1:
                raise ValidationError(
                    "'alias' is mutually exclusive, cannot be set with a "
                    f"combination of other {what}")
            if "@" not in alias or not _ALIAS_RE.match(alias):
                raise ValidationError(
                    "'alias' is improperly formatted, must match the "
                    "format 'family@version'")
            family, version = alias.split("@", 1)
            if family not in _AMI_FAMILIES:
                raise ValidationError(
                    "family is not supported, must be one of the following: "
                    "'al2', 'al2023', 'bottlerocket', 'windows2019', "
                    "'windows2022'")
            if family.startswith("windows") and version != "latest":
                raise ValidationError(
                    "windows families may only specify version 'latest'")
        for k, v in (dict(t.tags) if t.tags else {}).items():
            if not k or not v:
                raise ValidationError(
                    "empty tag keys or values aren't supported")


def validate_ec2nodeclass(nc) -> None:
    _validate_terms(nc.ami_selector_terms, "amiSelectorTerms",
                    allow_alias=True)
    _validate_terms(nc.subnet_selector_terms, "subnetSelectorTerms",
                    allow_name=False)
    _validate_terms(nc.security_group_selector_terms,
                    "securityGroupSelectorTerms")
    if not nc.role and not nc.instance_profile:
        raise ValidationError("role cannot be empty")
    if sum(1 for b in nc.block_device_mappings if b.root_volume) > 1:
        raise ValidationError(
            "must have only one blockDeviceMappings with rootVolume")
    for key in nc.tags:
        if L.is_restricted_tag(key):
            raise ValidationError(f"tag {key!r} is restricted")
    k = nc.kubelet
    for field_name, allowed in (("eviction_hard", _EVICTION_SIGNALS),
                                ("eviction_soft", _EVICTION_SIGNALS),
                                ("eviction_soft_grace_period",
                                 _EVICTION_SIGNALS),
                                ("kube_reserved", _RESERVED_KEYS),
                                ("system_reserved", _RESERVED_KEYS)):
        for key in getattr(k, field_name, None) or {}:
            if key not in allowed:
                raise ValidationError(
                    f"valid keys for {_camel(field_name)} are "
                    f"{sorted(allowed)}")
    soft = getattr(k, "eviction_soft", None) or {}
    grace = getattr(k, "eviction_soft_grace_period", None) or {}
    for key in soft:
        if key not in grace:
            raise ValidationError(
                "evictionSoft OwnerKey does not have a matching "
                "evictionSoftGracePeriod")
    for key in grace:
        if key not in soft:
            raise ValidationError(
                "evictionSoftGracePeriod OwnerKey does not have a matching "
                "evictionSoft")
    high = getattr(k, "image_gc_high_threshold_percent", None)
    low = getattr(k, "image_gc_low_threshold_percent", None)
    if high is not None and low is not None and high <= low:
        raise ValidationError(
            "imageGCHighThresholdPercent must be greater than "
            "imageGCLowThresholdPercent")


def _camel(snake: str) -> str:
    parts = snake.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def validate(obj) -> None:
    kind = getattr(obj, "kind", "")
    if kind == "NodePool":
        validate_nodepool(obj)
    elif kind == "NodeClaim":
        validate_nodeclaim(obj)
    elif kind == "EC2NodeClass":
        validate_ec2nodeclass(obj)


def validate_update(old, new) -> None:
    validate(new)
    kind = getattr(new, "kind", "")
    if kind == "NodePool":
        if new.template.node_class_ref.group != \
                old.template.node_class_ref.group:
            raise ValidationError("nodeClassRef.group is immutable")
        if new.template.node_class_ref.kind != \
                old.template.node_class_ref.kind:
            raise ValidationError("nodeClassRef.kind is immutable")
    elif kind == "EC2NodeClass":
        if old.role and new.role != old.role:
            raise ValidationError("immutable field changed")
