"""Kubernetes manifests for a job of the port (``persia_tpu/k8s_utils.py``).

A job YAML (per-role replicas, resources, env) renders to plain Pod and
Service manifests, wiring ``REPLICA_INDEX`` / ``REPLICA_SIZE``, the fleet
sizes and the coordinator's address into each role, as the JAX package
renders them; apply them with kubectl or any GitOps pipeline. Every pod
runs ``python -m persia_tpu_torch.launcher <role>``.

Job spec shape::

    jobName: my-job
    image: persia-tpu-runtime:latest
    coordinatorPort: 23333
    embeddingConfigPath: /config/embedding_config.yml
    globalConfigPath: /config/global_config.yml
    roles:
      embeddingParameterServer: {replicas: 2, env: {...}}
      embeddingWorker: {replicas: 2}
      nnWorker: {replicas: 1, gpu: {count: 1}}
      dataloader: {replicas: 1, entry: data_loader.py}

A role asks for cards with ``gpu: {count: N}``, which renders to the
container's ``resources.limits["nvidia.com/gpu"]``; the PersiaJob CRD's
role schema carries ``gpu`` where the JAX package's carries ``tpu``. A
spec with the JAX package's ``tpu:`` block (GKE TPU node selectors and a
``google.com/tpu`` limit) is refused by name.

Manifests are written with the port's YAML writer in insertion order, a
stream of documents, as ``yaml.safe_dump_all(..., sort_keys=False)``.

CLI: ``python -m persia_tpu_torch.k8s_utils gen job.yml > manifests.yml``
(also ``gencrd`` and ``validate``)
"""

import argparse
import copy
import sys
from typing import Dict, List

from persia_tpu_torch import _yaml
from persia_tpu_torch.utils import load_yaml

LAUNCHER_MODULE = "persia_tpu_torch.launcher"

_ROLE_LAUNCHER = {
    "embeddingParameterServer": "embedding-parameter-server",
    "embeddingWorker": "embedding-worker",
    "nnWorker": "nn-worker",
    "dataloader": "data-loader",
}


def _pod(job: str, image: str, role: str, index: int, replicas: int,
         command: List[str], env: Dict[str, str], extra: dict) -> dict:
    env_list = [{"name": k, "value": str(v)} for k, v in env.items()]
    container = {
        "name": role.lower(),
        "image": image,
        "command": command,
        "env": env_list,
    }
    if extra.get("resources"):
        container["resources"] = copy.deepcopy(extra["resources"])
    spec = {"containers": [container], "restartPolicy": "OnFailure"}
    if extra.get("gpu"):
        # cards through the NVIDIA device plugin's extended resource
        container.setdefault("resources", {}).setdefault("limits", {})[
            "nvidia.com/gpu"] = int(extra["gpu"].get("count", 1))
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"{job}-{role.lower()}-{index}",
            "labels": {"persia-job": job, "persia-role": role,
                       "replica-index": str(index)},
        },
        "spec": spec,
    }


def gen_manifests(spec: dict) -> List[dict]:
    job = spec["jobName"]
    image = spec.get("image", "persia-tpu-runtime:latest")
    coord_port = int(spec.get("coordinatorPort", 23333))
    coord_host = f"{job}-coordinator"
    manifests: List[dict] = []

    manifests.append(_pod(
        job, image, "coordinator", 0, 1,
        ["python", "-m", LAUNCHER_MODULE, "coordinator",
         "--host", "0.0.0.0", "--port", str(coord_port)],
        {}, {},
    ))
    manifests.append({
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": coord_host, "labels": {"persia-job": job}},
        "spec": {
            "selector": {"persia-job": job, "persia-role": "coordinator"},
            "ports": [{"port": coord_port, "targetPort": coord_port}],
        },
    })

    # Prometheus pushgateway (reference synthesizes one per job when
    # metrics are enabled, k8s/src/crd.rs:435-464); every role pod gets
    # PERSIA_METRICS_GATEWAY_ADDR pointing at it.
    metrics = spec.get("metrics", {})
    gateway_env = {}
    if metrics.get("enabled"):
        gw_host = f"{job}-metrics-gateway"
        gw_port = int(metrics.get("port", 9091))
        manifests.append({
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": gw_host,
                "labels": {"persia-job": job,
                           "persia-role": "metricsGateway"},
            },
            "spec": {
                "containers": [{
                    "name": "pushgateway",
                    "image": metrics.get("image", "prom/pushgateway:v1.9.0"),
                    # the process defaults to :9091; a non-default port
                    # must reach the listener, not just the Service
                    "args": [f"--web.listen-address=:{gw_port}"],
                    "ports": [{"containerPort": gw_port}],
                }],
                "restartPolicy": "OnFailure",
            },
        })
        manifests.append({
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": gw_host, "labels": {"persia-job": job}},
            "spec": {
                "selector": {"persia-job": job,
                             "persia-role": "metricsGateway"},
                "ports": [{"port": gw_port, "targetPort": gw_port}],
            },
        })
        gateway_env = {"PERSIA_METRICS_GATEWAY_ADDR": f"{gw_host}:{gw_port}"}

    roles = spec.get("roles", {})
    unknown = set(roles) - set(_ROLE_LAUNCHER)
    if unknown:
        raise ValueError(
            f"unknown role(s) {sorted(unknown)}; valid roles: "
            f"{sorted(_ROLE_LAUNCHER)}")
    for role, conf in roles.items():
        if "tpu" in conf:
            raise ValueError(
                f"role {role}: the 'tpu' block asks for TPU chips, which "
                f"this package does not run on; ask for cards with "
                f"'gpu: {{count: N}}'")
    def _replica_count(role_name: str) -> int:
        # same default (1) the pod-rendering loop uses: a role present
        # without an explicit replicas key is one replica, not zero
        conf = roles.get(role_name)
        return int(conf.get("replicas", 1)) if conf is not None else 0

    n_ps = _replica_count("embeddingParameterServer")
    n_workers = _replica_count("embeddingWorker")
    n_loaders = _replica_count("dataloader")
    n_trainers = _replica_count("nnWorker")
    for role, conf in roles.items():
        replicas = int(conf.get("replicas", 1))
        launcher_role = _ROLE_LAUNCHER[role]
        for i in range(replicas):
            env = {
                "REPLICA_INDEX": i,
                "REPLICA_SIZE": replicas,
                "PERSIA_COORDINATOR_ADDR": f"{coord_host}:{coord_port}",
                "PERSIA_NUM_PS": n_ps,
                # fleet sizes every role needs for rendezvous waits
                "PERSIA_NUM_WORKERS": n_workers,
                "PERSIA_NUM_DATALOADERS": n_loaders,
                **gateway_env,
                **conf.get("env", {}),
            }
            # every role may need the trainer count (data-loaders wait
            # for all trainers before streaming); trainers additionally
            # follow the RANK/WORLD_SIZE contract (env.py), matching the
            # reference's torch.distributed launch env
            env.setdefault("WORLD_SIZE", n_trainers)
            if role == "nnWorker":
                env.setdefault("RANK", i)
            command = ["python", "-m", LAUNCHER_MODULE, launcher_role]
            if role == "embeddingWorker":
                command += ["--embedding-config",
                            spec["embeddingConfigPath"],
                            "--num-ps", str(n_ps)]
                if spec.get("globalConfigPath"):
                    command += ["--global-config", spec["globalConfigPath"]]
            elif role == "embeddingParameterServer":
                command += ["--port", str(conf.get("port", 8887))]
                if spec.get("globalConfigPath"):
                    command += ["--global-config", spec["globalConfigPath"]]
            elif conf.get("entry"):
                command += [conf["entry"]]
            manifests.append(_pod(job, image, role, i, replicas, command,
                                  env, conf))
    return manifests


def gen_crd() -> dict:
    """The PersiaJob CustomResourceDefinition (reference: gencrd.rs
    emitting jobs.persia.com from the Rust CRD types, crd.rs:42-64).

    A PersiaJob resource's spec is exactly the job-spec shape
    ``gen_manifests`` consumes, a role's accelerator block being
    ``gpu: {count}``; the operator (``k8s_operator.py --from-crd``)
    watches these resources and reconciles them."""
    role_schema = {
        "type": "object",
        "properties": {
            "replicas": {"type": "integer", "minimum": 0},
            "entry": {"type": "string"},
            "port": {"type": "integer"},
            "env": {"type": "object",
                    "additionalProperties": {"type": "string"}},
            "resources": {"type": "object",
                          "x-kubernetes-preserve-unknown-fields": True},
            "gpu": {
                "type": "object",
                "properties": {
                    "count": {"type": "integer", "minimum": 0},
                },
            },
        },
    }
    spec_schema = {
        "type": "object",
        "required": ["jobName"],
        "properties": {
            "jobName": {"type": "string"},
            "image": {"type": "string"},
            "coordinatorPort": {"type": "integer"},
            "embeddingConfigPath": {"type": "string"},
            "globalConfigPath": {"type": "string"},
            "metrics": {
                "type": "object",
                "properties": {
                    "enabled": {"type": "boolean"},
                    "port": {"type": "integer"},
                    "image": {"type": "string"},
                },
            },
            "roles": {
                "type": "object",
                # only the four launcher roles exist; an open schema
                # would admit CRs that can never converge (the manifest
                # generator has no launcher for unknown roles)
                "properties": {name: role_schema for name in _ROLE_LAUNCHER},
                "additionalProperties": False,
            },
        },
    }
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "persiajobs.persia.com"},
        "spec": {
            "group": "persia.com",
            "scope": "Namespaced",
            "names": {
                "plural": "persiajobs",
                "singular": "persiajob",
                "kind": "PersiaJob",
                "shortNames": ["pj"],
            },
            "versions": [{
                "name": "v1",
                "served": True,
                "storage": True,
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "properties": {"spec": spec_schema},
                }},
            }],
        },
    }


def _validate_structural(manifest: dict) -> List[str]:
    """Fallback schema checks when kubectl is absent: the structural
    invariants `kubectl apply --dry-run=client` would reject."""
    errs = []
    meta = manifest.get("metadata")
    name = meta.get("name", "?") if isinstance(meta, dict) else "?"
    where = f"{manifest.get('kind', '?')}/{name}"
    for key in ("apiVersion", "kind"):
        if not manifest.get(key):
            errs.append(f"{where}: missing {key}")
    if not isinstance(meta, dict) or not meta.get("name"):
        errs.append(f"{where}: missing metadata.name")
    elif not all(c.isalnum() or c in "-." for c in meta["name"]) or \
            meta["name"] != meta["name"].lower():
        errs.append(f"{where}: invalid DNS-1123 name {meta['name']!r}")
    kind = manifest.get("kind")
    spec = manifest.get("spec", {})
    if not isinstance(spec, dict):
        errs.append(f"{where}: spec must be a mapping, "
                    f"got {type(spec).__name__}")
        return errs
    if kind == "Pod":
        containers = spec.get("containers")
        if not isinstance(containers, list) or not containers:
            errs.append(f"{where}: Pod needs spec.containers")
        else:
            for c in containers:
                if not isinstance(c, dict):
                    errs.append(f"{where}: container entries must be "
                                f"mappings, got {type(c).__name__}")
                    continue
                if not c.get("name") or not c.get("image"):
                    errs.append(f"{where}: container needs name + image")
                if "command" in c and not isinstance(c["command"], list):
                    errs.append(f"{where}: command must be a list")
                env = c.get("env", [])
                for e in (env if isinstance(env, list) else []):
                    if not isinstance(e, dict):
                        errs.append(f"{where}: env entries must be mappings")
                        continue
                    if not isinstance(e.get("value", ""), str):
                        errs.append(
                            f"{where}: env {e.get('name')} value must be a "
                            f"string, got {type(e.get('value')).__name__}")
    elif kind == "Service":
        if not spec.get("ports"):
            errs.append(f"{where}: Service needs spec.ports")
        if not spec.get("selector"):
            errs.append(f"{where}: Service needs spec.selector")
    elif kind == "CustomResourceDefinition":
        names = spec.get("names")
        names = names if isinstance(names, dict) else {}
        if not (spec.get("group") and spec.get("versions") and
                names.get("plural") and names.get("kind")):
            errs.append(f"{where}: CRD needs group/versions/names")
        elif isinstance(meta, dict) and meta.get("name") != \
                f"{names['plural']}.{spec['group']}":
            # only meaningful once group+names exist; otherwise it's a
            # spurious cascade comparing against the literal "None.None"
            errs.append(f"{where}: CRD name must be <plural>.<group>")
    return errs


def _validate_all_structural(manifests: List[dict]) -> None:
    errs = [e for m in manifests for e in _validate_structural(m)]
    if errs:
        raise ValueError("manifest validation failed:\n" +
                         "\n".join(f"  - {e}" for e in errs))


def validate_manifests(manifests: List[dict],
                       kubectl: str = "kubectl") -> None:
    """Validate rendered manifests before they near a cluster: through
    ``kubectl apply --dry-run=client`` when the CLI exists (the intent of
    the reference's e2e harness, k8s/src/bin/e2e.rs:13-17), else through
    the structural checks. Raises ValueError with every problem found.

    kubectl with no reachable cluster/kubeconfig fails for connectivity
    reasons, not manifest reasons — that case falls back to the
    structural checks instead of rejecting valid manifests."""
    import shutil
    import subprocess

    if shutil.which(kubectl):
        doc = _yaml.dump_all(manifests, sort_keys=False)
        proc = subprocess.run(
            [kubectl, "apply", "--dry-run=client", "--validate=true",
             "-o", "name", "-f", "-"],
            input=doc, capture_output=True, text=True,
        )
        if proc.returncode == 0:
            return
        stderr = proc.stderr.strip()
        connectivity = any(tok in stderr.lower() for tok in (
            "connection refused", "unable to connect", "dial tcp",
            "no configuration has been provided", "missing or incomplete",
            "failed to download openapi", "cluster unreachable",
            "no such host",
        ))
        if not connectivity:
            raise ValueError(
                f"kubectl client dry-run rejected manifests:\n{stderr}")
        # fall through: kubectl present but no cluster — structural checks
    _validate_all_structural(manifests)


def validate_spec(spec: dict) -> List[dict]:
    """Render a job spec and structurally validate every manifest (no
    kubectl/cluster dependence — what the REST /apply pre-check needs).
    Returns the rendered manifests; raises on any problem."""
    manifests = gen_manifests(spec)
    _validate_all_structural(manifests)
    return manifests


def main(argv=None):
    p = argparse.ArgumentParser(prog="persia-torch-k8s")
    p.add_argument("action", choices=["gen", "gencrd", "validate"])
    p.add_argument("job_yaml", nargs="?")
    args = p.parse_args(argv)
    if args.action == "gencrd":
        sys.stdout.write(_yaml.dump(gen_crd(), sort_keys=False))
        return
    if not args.job_yaml:
        p.error(f"{args.action} requires a job YAML file")
    spec = load_yaml(args.job_yaml)
    manifests = gen_manifests(spec)
    if args.action == "validate":
        validate_manifests(manifests + [gen_crd()])
        print(f"ok: {len(manifests)} manifests + CRD valid")
        return
    sys.stdout.write(_yaml.dump_all(manifests, sort_keys=False))


if __name__ == "__main__":
    main()
