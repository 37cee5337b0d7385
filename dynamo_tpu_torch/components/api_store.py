"""API store: versioned registry of packaged serving graphs.

A copy of ``dynamo_tpu/components/api_store.py``: the same REST surface,
sqlite schema and bodies, so either package's ``package`` and ``serve
--package`` commands talk to either store.  Its ``/manifests`` route
renders through the port's ``deploy/renderer.py`` (GPU resources).

Reference parity: deploy/dynamo/api-store (FastAPI + Postgres store of
packaged graphs/"bentos" that the k8s operator pulls deployment specs
from).  Rebuilt lean: aiohttp + sqlite, storing DynamoTpuDeployment specs
(deploy/renderer.py shape) with versions, and serving rendered k8s
manifests straight from the store.

REST surface:
  POST   /api/v1/graphs                     {"name", "spec": <yaml|dict>, "labels"?}
  GET    /api/v1/graphs                     list graphs (latest version each)
  GET    /api/v1/graphs/{name}              all versions
  GET    /api/v1/graphs/{name}/{ver}        one version (spec + metadata)
  DELETE /api/v1/graphs/{name}/{ver}
  GET    /api/v1/graphs/{name}/{ver}/manifests   rendered k8s objects (JSON list)

Packaged graphs (the reference's "bento" archives — code + manifest,
built by the ``package build`` command, deploy/packaging.py; weights ride
the model store instead):
  POST   /api/v1/packages                   raw tar.gz body -> {name, version}
  GET    /api/v1/packages                   list packages (latest each)
  GET    /api/v1/packages/{name}            all versions (manifest metadata)
  GET    /api/v1/packages/{name}/{ver}      manifest ("latest" ok)
  GET    /api/v1/packages/{name}/{ver}/archive   the tar.gz bytes
  DELETE /api/v1/packages/{name}/{ver}

Run via ``python -m dynamo_tpu_torch api-store --db graphs.db --port 7180``.
"""

from __future__ import annotations

import asyncio
import json
import sqlite3
import time
from typing import Optional

import yaml
from aiohttp import web

from dynamo_tpu_torch.deploy.renderer import DeploymentSpec, render_manifests

__all__ = ["ApiStore"]


class ApiStore:
    def __init__(self, db_path: str = ":memory:", host: str = "127.0.0.1", port: int = 7180):
        self.db = sqlite3.connect(db_path)
        self.db.execute(
            """CREATE TABLE IF NOT EXISTS graphs (
                 name TEXT NOT NULL,
                 version INTEGER NOT NULL,
                 spec TEXT NOT NULL,
                 labels TEXT NOT NULL DEFAULT '{}',
                 created_at REAL NOT NULL,
                 PRIMARY KEY (name, version)
               )"""
        )
        self.db.execute(
            """CREATE TABLE IF NOT EXISTS packages (
                 name TEXT NOT NULL,
                 version INTEGER NOT NULL,
                 manifest TEXT NOT NULL,
                 archive BLOB NOT NULL,
                 created_at REAL NOT NULL,
                 PRIMARY KEY (name, version)
               )"""
        )
        self.host = host
        self.port = port
        self._runner: Optional[web.AppRunner] = None

    # ------------------------------------------------------------------ CRUD
    def put_graph(self, name: str, spec: dict, labels: Optional[dict] = None) -> int:
        # the spec must render — reject broken uploads at the door
        render_manifests(self._to_spec(spec))
        return self._insert_graph(name, spec, labels)

    def _insert_graph(self, name: str, spec: dict,
                      labels: Optional[dict] = None) -> int:
        # sqlite connections are thread-bound: this must run on the
        # thread that created self.db (the event loop thread)
        cur = self.db.execute(
            "SELECT COALESCE(MAX(version), 0) FROM graphs WHERE name = ?", (name,)
        )
        version = cur.fetchone()[0] + 1
        self.db.execute(
            "INSERT INTO graphs (name, version, spec, labels, created_at) VALUES (?,?,?,?,?)",
            (name, version, json.dumps(spec), json.dumps(labels or {}), time.time()),
        )
        self.db.commit()
        return version

    def list_graphs(self) -> list[dict]:
        cur = self.db.execute(
            """SELECT name, MAX(version), created_at FROM graphs
               GROUP BY name ORDER BY name"""
        )
        return [
            {"name": n, "latest_version": v, "created_at": t}
            for n, v, t in cur.fetchall()
        ]

    def get_versions(self, name: str) -> list[dict]:
        cur = self.db.execute(
            "SELECT version, labels, created_at FROM graphs WHERE name = ? ORDER BY version",
            (name,),
        )
        return [
            {"version": v, "labels": json.loads(l), "created_at": t}
            for v, l, t in cur.fetchall()
        ]

    def get_graph(self, name: str, version: Optional[int] = None) -> Optional[dict]:
        if version is None:
            cur = self.db.execute(
                "SELECT version, spec, labels, created_at FROM graphs "
                "WHERE name = ? ORDER BY version DESC LIMIT 1", (name,),
            )
        else:
            cur = self.db.execute(
                "SELECT version, spec, labels, created_at FROM graphs "
                "WHERE name = ? AND version = ?", (name, version),
            )
        row = cur.fetchone()
        if row is None:
            return None
        v, spec, labels, t = row
        return {
            "name": name, "version": v, "spec": json.loads(spec),
            "labels": json.loads(labels), "created_at": t,
        }

    def delete_graph(self, name: str, version: int) -> bool:
        cur = self.db.execute(
            "DELETE FROM graphs WHERE name = ? AND version = ?", (name, version)
        )
        self.db.commit()
        return cur.rowcount > 0

    @staticmethod
    def _to_spec(spec: dict) -> DeploymentSpec:
        return DeploymentSpec.from_yaml(yaml.safe_dump(spec))

    def _validate_spec(self, spec: dict) -> None:
        """Blocking (template read_text): run via asyncio.to_thread from
        handlers."""
        render_manifests(self._to_spec(spec))

    # ------------------------------------------------------------- packages
    def put_package(self, archive: bytes) -> tuple[str, int]:
        """Store a package archive; name comes from its own (validated)
        manifest.  Returns (name, version)."""
        from dynamo_tpu_torch.deploy.packaging import read_manifest

        manifest = read_manifest(archive)  # raises PackageError if bad
        name = manifest["name"]
        cur = self.db.execute(
            "SELECT COALESCE(MAX(version), 0) FROM packages WHERE name = ?",
            (name,),
        )
        version = cur.fetchone()[0] + 1
        self.db.execute(
            "INSERT INTO packages (name, version, manifest, archive, "
            "created_at) VALUES (?,?,?,?,?)",
            (name, version, json.dumps(manifest), archive, time.time()),
        )
        self.db.commit()
        return name, version

    def list_packages(self) -> list[dict]:
        cur = self.db.execute(
            """SELECT name, MAX(version), created_at FROM packages
               GROUP BY name ORDER BY name"""
        )
        return [
            {"name": n, "latest_version": v, "created_at": t}
            for n, v, t in cur.fetchall()
        ]

    def package_versions(self, name: str) -> list[dict]:
        cur = self.db.execute(
            "SELECT version, manifest, created_at FROM packages "
            "WHERE name = ? ORDER BY version", (name,),
        )
        return [
            {"version": v, "entry": json.loads(m).get("entry"),
             "created_at": t}
            for v, m, t in cur.fetchall()
        ]

    def get_package(self, name: str, version: Optional[int] = None,
                    with_archive: bool = False) -> Optional[dict]:
        # fetch the (potentially large) archive blob only when asked —
        # metadata requests must not materialize it
        cols = ("version, manifest, created_at, archive" if with_archive
                else "version, manifest, created_at")
        q = f"SELECT {cols} FROM packages WHERE name = ?"
        args: tuple = (name,)
        if version is None:
            q += " ORDER BY version DESC LIMIT 1"
        else:
            q += " AND version = ?"
            args = (name, version)
        row = self.db.execute(q, args).fetchone()
        if row is None:
            return None
        out = {"name": name, "version": row[0],
               "manifest": json.loads(row[1]), "created_at": row[2]}
        if with_archive:
            out["archive"] = row[3]
        return out

    def delete_package(self, name: str, version: int) -> bool:
        cur = self.db.execute(
            "DELETE FROM packages WHERE name = ? AND version = ?",
            (name, version),
        )
        self.db.commit()
        return cur.rowcount > 0

    # ------------------------------------------------------------------ HTTP
    async def _post_graph(self, request: web.Request) -> web.Response:
        body = await request.json()
        spec = body.get("spec")
        if isinstance(spec, str):
            spec = yaml.safe_load(spec)
        if not isinstance(spec, dict) or "name" not in body:
            raise web.HTTPBadRequest(text="need {name, spec}")
        try:
            # the render validation reads spec templates off disk
            # (DeploymentSpec.from_yaml) — keep it off the event loop;
            # the sqlite insert stays here (connections are thread-bound)
            await asyncio.to_thread(self._validate_spec, spec)
        except (KeyError, ValueError, TypeError) as e:
            raise web.HTTPUnprocessableEntity(text=f"spec does not render: {e}")
        version = self._insert_graph(body["name"], spec, body.get("labels"))
        return web.json_response({"name": body["name"], "version": version}, status=201)

    async def _list(self, request: web.Request) -> web.Response:
        return web.json_response(self.list_graphs())

    async def _versions(self, request: web.Request) -> web.Response:
        name = request.match_info["name"]
        versions = self.get_versions(name)
        if not versions:
            raise web.HTTPNotFound
        return web.json_response(versions)

    async def _get(self, request: web.Request) -> web.Response:
        g = self.get_graph(
            request.match_info["name"], int(request.match_info["ver"])
        )
        if g is None:
            raise web.HTTPNotFound
        return web.json_response(g)

    async def _delete(self, request: web.Request) -> web.Response:
        ok = self.delete_graph(
            request.match_info["name"], int(request.match_info["ver"])
        )
        if not ok:
            raise web.HTTPNotFound
        return web.json_response({"deleted": True})

    async def _manifests(self, request: web.Request) -> web.Response:
        g = self.get_graph(
            request.match_info["name"], int(request.match_info["ver"])
        )
        if g is None:
            raise web.HTTPNotFound
        spec = await asyncio.to_thread(self._to_spec, g["spec"])
        return web.json_response(render_manifests(spec))

    # ------------------------------------------------------- packages HTTP
    @staticmethod
    def _ver_arg(request: web.Request) -> Optional[int]:
        ver = request.match_info["ver"]
        if ver == "latest":
            return None
        try:
            return int(ver)
        except ValueError:
            raise web.HTTPBadRequest(
                text=f"version must be an integer or 'latest', got {ver!r}"
            ) from None

    async def _post_package(self, request: web.Request) -> web.Response:
        from dynamo_tpu_torch.deploy.packaging import PackageError

        archive = await request.read()
        try:
            name, version = self.put_package(archive)
        except PackageError as e:
            raise web.HTTPUnprocessableEntity(text=str(e))
        return web.json_response({"name": name, "version": version},
                                 status=201)

    async def _list_packages(self, request: web.Request) -> web.Response:
        return web.json_response(self.list_packages())

    async def _package_versions(self, request: web.Request) -> web.Response:
        versions = self.package_versions(request.match_info["name"])
        if not versions:
            raise web.HTTPNotFound
        return web.json_response(versions)

    async def _get_package(self, request: web.Request) -> web.Response:
        g = self.get_package(request.match_info["name"],
                             self._ver_arg(request))
        if g is None:
            raise web.HTTPNotFound
        return web.json_response(g)

    async def _get_archive(self, request: web.Request) -> web.Response:
        g = self.get_package(request.match_info["name"],
                             self._ver_arg(request), with_archive=True)
        if g is None:
            raise web.HTTPNotFound
        return web.Response(
            body=g["archive"], content_type="application/gzip",
            headers={"X-Package-Version": str(g["version"])},
        )

    async def _delete_package(self, request: web.Request) -> web.Response:
        ver = self._ver_arg(request)
        if ver is None:
            raise web.HTTPBadRequest(text="delete needs an explicit version")
        if not self.delete_package(request.match_info["name"], ver):
            raise web.HTTPNotFound
        return web.json_response({"deleted": True})

    async def start(self) -> "ApiStore":
        app = web.Application(client_max_size=256 << 20)  # code archives
        app.router.add_post("/api/v1/graphs", self._post_graph)
        app.router.add_get("/api/v1/graphs", self._list)
        app.router.add_get("/api/v1/graphs/{name}", self._versions)
        app.router.add_get("/api/v1/graphs/{name}/{ver}", self._get)
        app.router.add_delete("/api/v1/graphs/{name}/{ver}", self._delete)
        app.router.add_get("/api/v1/graphs/{name}/{ver}/manifests", self._manifests)
        app.router.add_post("/api/v1/packages", self._post_package)
        app.router.add_get("/api/v1/packages", self._list_packages)
        app.router.add_get("/api/v1/packages/{name}", self._package_versions)
        app.router.add_get("/api/v1/packages/{name}/{ver}", self._get_package)
        app.router.add_get("/api/v1/packages/{name}/{ver}/archive",
                           self._get_archive)
        app.router.add_delete("/api/v1/packages/{name}/{ver}",
                              self._delete_package)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        self.port = self._runner.addresses[0][1]
        return self

    async def stop(self) -> None:
        if self._runner:
            await self._runner.cleanup()
            self._runner = None
        self.db.close()
